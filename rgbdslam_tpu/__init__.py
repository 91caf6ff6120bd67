"""Former name of the ``rgbdslam`` package, kept so that existing imports
and ``python -m <this package>.cli`` keep working. Each submodule imported
under this name is the ``rgbdslam`` module itself."""

import rgbdslam as _real
from rgbdslam._alias import install

install(__name__)


def __getattr__(name):
    return getattr(_real, name)
