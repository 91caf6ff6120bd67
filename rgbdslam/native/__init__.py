from rgbdslam.native.framepipe import (  # noqa: F401
    FramePipe,
    decode_png_gray,
    ensure_built,
    native_available,
)
