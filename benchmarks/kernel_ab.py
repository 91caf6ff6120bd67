"""A/B of each hand-written GPU kernel, and of each re-chosen XLA form,
against the alternative, alone and inside the jitted VO step.

Variants:
  gicp     triton (ops/pallas_kernels.gicp_refine_kernel) | xla (the
           fori_loop in solvers/icp.gicp_refine)
  detect   fused (ops/fast.masked_score_map, the live form) | reference
           (the composition in ops/fast.masked_score_map_reference)
  hamming  popcount | mxu (ops/hamming.py)

"Alone" is the device time of one call, from a profiler trace (sum of the
device kernel durations, and their count = launches). "VO step" is the
B=8 scan of slam/pipeline.PipelinedOdometry at 640x480 / 1024 features:
host wall per frame over repeated batches (block_until_ready), and the
trace's device busy time per frame. Variants run in turns in one process.

  python benchmarks/kernel_ab.py [--ops gicp detect hamming]   # on a GPU
Writes chiprun_out/kernel_ab.json; prints one summary line per variant.

  python benchmarks/kernel_ab.py --gicp-sizes 1024 2048 4096 --gicp-warps 8 16
GICP alone by point count and warp count (kernel vs XLA loop, with parity);
writes chiprun_out/kernel_ab_gicp_sizes.json.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from rgbdslam.config import IcpConfig, SlamConfig  # noqa: E402
from rgbdslam.frontend.frame import build_frame_features  # noqa: E402
from rgbdslam.geometry.camera import SYNTHETIC  # noqa: E402
from rgbdslam.io.synthetic import SyntheticDataset  # noqa: E402
from rgbdslam.ops import backend, fast, hamming  # noqa: E402
from rgbdslam.slam.pipeline import PipelinedOdometry  # noqa: E402
from rgbdslam.utils.compile_cache import enable_compile_cache  # noqa: E402

class Variant:
    """Context: route the program through one implementation."""

    def __init__(self, op, impl):
        self.op, self.impl = op, impl

    def __enter__(self):
        self.saved = (dict(backend.KERNELS["gpu"]), hamming.DEFAULT_IMPL,
                      fast.masked_score_map)
        if self.op == "hamming":
            hamming.DEFAULT_IMPL = self.impl
        elif self.op == "detect":
            if self.impl == "reference":
                fast.masked_score_map = fast.masked_score_map_reference
        else:
            backend.KERNELS["gpu"][self.op] = self.impl
        jax.clear_caches()          # inner jits must re-trace
        return self

    def __exit__(self, *exc):
        backend.KERNELS["gpu"].update(self.saved[0])
        hamming.DEFAULT_IMPL, fast.masked_score_map = self.saved[1:]
        jax.clear_caches()


def device_profile(fn, args, n_calls, tag):
    """(device busy ms per call, kernel launches per call, top kernels)
    from a profiler trace of n_calls back-to-back calls."""
    jax.block_until_ready(fn(*args))
    tdir = tempfile.mkdtemp(prefix=f"trace_{tag}_")
    with jax.profiler.trace(tdir):
        for _ in range(n_calls):
            out = fn(*args)
        jax.block_until_ready(out)
    path = glob.glob(os.path.join(tdir, "plugins", "profile", "*",
                                  "*.xplane.pb"))[0]
    prof = jax.profiler.ProfileData.from_file(path)
    busy_ns, launches, by_name, lines = 0.0, 0, {}, {}
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines[f"{plane.name}/{line.name}"] = len(evs)
            # kernel events live on the stream lines; the derived "XLA Ops"
            # / "XLA Modules" lines repeat them
            if not line.name.startswith("Stream"):
                continue
            for e in evs:
                busy_ns += e.duration_ns
                launches += 1
                by_name[e.name] = by_name.get(e.name, 0.0) + e.duration_ns
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"device_ms_per_call": busy_ns / n_calls / 1e6,
            "launches_per_call": launches / n_calls,
            "top_kernels_ms_per_call": [(k[:80], v / n_calls / 1e6)
                                        for k, v in top],
            "trace_lines": lines}


def wall_ms(fn, args, reps):
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def gicp_case(n, rng):
    """(fn, args): the 10-iteration GICP polish over n points."""
    p1 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    p1[:, 2] += 2.5
    p2 = p1 + rng.normal(scale=0.004, size=(n, 3)).astype(np.float32)
    a = rng.normal(scale=0.02, size=(n, 3, 3)).astype(np.float32)
    C = a @ a.transpose(0, 2, 1) + 1e-4 * np.eye(3, dtype=np.float32)
    gicp_args = [jnp.asarray(x) for x in (p1, p2, rng.random(n) > 0.2,
                                          np.eye(4, dtype=np.float32), C)]
    cfg = IcpConfig(max_iterations=10, max_correspondence_dist=0.15)
    from rgbdslam.solvers.icp import gicp_refine

    def gicp(p1, p2, v, T, C):
        return gicp_refine(p1, p2, v, T, None, cfg, C1=C, C2=C)[0]

    return gicp, gicp_args


def alone_cases():
    rng = np.random.default_rng(0)
    imgs = [jnp.asarray(rng.integers(0, 256, (480 >> l, 640 >> l))
                        .astype(np.float32)) for l in range(4)]

    def detect_all(*ims):
        return [fast.masked_score_map(im, 20.0)[0] for im in ims]

    gicp, gicp_args = gicp_case(1024, rng)
    d = [jnp.asarray(rng.integers(0, 2**32, (1024, 8), dtype=np.uint32))
         for _ in range(2)]
    v = jnp.ones((1024,), bool)
    from rgbdslam.frontend.matcher import match_descriptors

    def match(d1, d2):
        return match_descriptors(d1, v, d2, v, 0.9).idx2

    return {"detect": (detect_all, imgs), "gicp": (gicp, gicp_args),
            "hamming": (match, d)}


def gicp_size_sweep(sizes, warps, reps):
    """GICP alone by point count: the Triton kernel at each warp count
    (size bound lifted) vs the XLA loop, with max |T diff| between them.
    A variant that fails to compile is recorded, and the run then exits
    non-zero."""
    from rgbdslam.ops import pallas_kernels

    results, failed = {}, []
    saved = (pallas_kernels._gicp_warps, dict(backend.KERNEL_MAX_SIZE))
    backend.KERNEL_MAX_SIZE["gicp"] = max(sizes)
    try:
        for rnd in range(2):
            for n in sizes:
                fn, a = gicp_case(n, np.random.default_rng(n))
                with Variant("gicp", "xla"):
                    T_x = np.asarray(jax.jit(fn)(*a))
                    xla = device_profile(jax.jit(fn), a, reps, f"gx{n}")
                print(f"gicp N={n} turn {rnd} xla: "
                      f"{xla['device_ms_per_call']:.4f} ms, "
                      f"{xla['launches_per_call']:.0f} launches", flush=True)
                results.setdefault(f"{n}/xla", []).append(
                    xla["device_ms_per_call"])
                for w in warps:
                    pallas_kernels._gicp_warps = lambda n_pad, w=w: w
                    tag = f"{n}/triton_w{w}"
                    with Variant("gicp", "triton"):
                        try:
                            T_k = np.asarray(jax.jit(fn)(*a))
                            tri = device_profile(jax.jit(fn), a, reps,
                                                 f"g{n}_w{w}")
                        except Exception as e:   # recorded, exits non-zero
                            failed.append(tag)
                            results[tag] = f"{type(e).__name__}: {e}"[:300]
                            print(f"gicp {tag}: FAILED {results[tag]}")
                            continue
                    diff = float(np.abs(T_k - T_x).max())
                    print(f"gicp N={n} turn {rnd} triton {w} warps: "
                          f"{tri['device_ms_per_call']:.4f} ms, "
                          f"{tri['launches_per_call']:.0f} launches, "
                          f"max |T diff| vs xla {diff:.3g}", flush=True)
                    results.setdefault(tag, []).append(
                        (tri["device_ms_per_call"], diff))
    finally:
        pallas_kernels._gicp_warps = saved[0]
        backend.KERNEL_MAX_SIZE.update(saved[1])
        jax.clear_caches()
    return results, failed


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--batches", type=int, default=12)
    ap.add_argument("--ops", nargs="+", default=["gicp", "detect", "hamming"])
    ap.add_argument("--gicp-sizes", type=int, nargs="+",
                    help="only: the GICP kernel vs the XLA loop alone at "
                         "these point counts")
    ap.add_argument("--gicp-warps", type=int, nargs="+", default=[8])
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("kernel_ab needs a GPU")
    enable_compile_cache()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    if args.gicp_sizes:
        results, failed = gicp_size_sweep(args.gicp_sizes, args.gicp_warps,
                                          args.reps)
        results["device_kind"] = jax.devices()[0].device_kind
        with open(os.path.join(ROOT, "chiprun_out",
                               "kernel_ab_gicp_sizes.json"), "w") as f:
            json.dump(results, f, indent=1)
        if failed:
            raise SystemExit(f"failed to compile or run: {failed}")
        return

    cfg = SlamConfig()
    cam = SYNTHETIC
    ds = SyntheticDataset(n_frames=16, cam=cam, trajectory="sweep")
    frames = [ds.grab(i)[1:] for i in range(len(ds))]
    B = 8
    grays = jnp.stack([frames[i][0] for i in range(1, B + 1)])
    depths = jnp.stack([frames[i][1] for i in range(1, B + 1)])
    key = jax.random.PRNGKey(0)
    cases = alone_cases()
    variants = {"gicp": ["triton", "xla"], "detect": ["fused", "reference"],
                "hamming": ["popcount", "mxu"]}
    variants = {op: variants[op] for op in args.ops}
    results = {"device_kind": jax.devices()[0].device_kind}
    for rnd in range(2):                       # two turns per variant
        for op, impls in variants.items():
            for impl in (impls if rnd == 0 else impls[::-1]):
                with Variant(op, impl):
                    fn, a = cases[op]
                    alone = device_profile(jax.jit(fn), a, args.reps,
                                           f"{op}_{impl}")
                    f0 = build_frame_features(cam, *frames[0], cfg.extractor)
                    step = PipelinedOdometry(cam, cfg, batch=B).step
                    t0 = time.perf_counter()
                    jax.block_until_ready(step(f0, grays, depths, key))
                    compile_s = time.perf_counter() - t0
                    ms = wall_ms(step, (f0, grays, depths, key),
                                 args.batches) / B
                    vo = device_profile(step, (f0, grays, depths, key), 3,
                                        f"vo_{op}_{impl}")
                r = results.setdefault(f"{op}/{impl}", [])
                r.append({"alone": alone, "vo_wall_ms_per_frame": ms,
                          "vo_device_ms_per_frame":
                              vo["device_ms_per_call"] / B,
                          "vo_launches_per_frame":
                              vo["launches_per_call"] / B,
                          "vo_compile_s": compile_s,
                          "vo_top": vo["top_kernels_ms_per_call"]})
                print(f"{op}/{impl} turn {rnd}: alone "
                      f"{alone['device_ms_per_call']:.4f} ms device, "
                      f"{alone['launches_per_call']:.1f} launches; VO step "
                      f"{ms:.4f} ms/frame wall, "
                      f"{vo['device_ms_per_call'] / B:.4f} ms/frame device, "
                      f"{vo['launches_per_call'] / B:.1f} launches/frame, "
                      f"compile {compile_s:.1f} s", flush=True)
    with open(os.path.join(ROOT, "chiprun_out", "kernel_ab.json"), "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
