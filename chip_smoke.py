"""Smoke test of the SLAM main path on one GPU, at deployment size.

Deployment size is a Kinect-class stream: 640x480 RGB-D, 1024 features,
4 pyramid levels, the shipped vocabulary, Mahalanobis RANSAC + GICP polish
(the SlamConfig defaults), over the 128-frame synthetic multi-room tour.

Phases; any failure raises and the script exits non-zero:
  (a) device check: JAX's first device must be a GPU;
  (b) kernel parity: the ``gpu``-marked tests (tests/test_gpu_kernels.py)
      run every kernel compiled for the card against its plain reference;
  (c) VO: the tracking step of ``__graft_entry__.entry()`` on 16 tour frames,
      per-frame T21 compared with the same step on the CPU backend;
  (d) full SLAM through the CLI, per frame and ``--batch 8``: keyframes, a
      loop closure with its pose-graph solves, ATE <= 0.05 m each.

The last stdout line is the JSON result, printed only when every phase
passed. Usage:

  python chip_smoke.py              # phases (a)-(d) on one GPU
  python chip_smoke.py --multi-gpu  # only: the tour with distributed=True
                                    # over 4 GPUs vs one GPU, then
                                    # __graft_entry__.dryrun_multichip(4)
  python chip_smoke.py --cpu-rehearsal [--multi-gpu]
                                    # the same on the CPU backend (with
                                    # XLA_FLAGS=--xla_force_host_platform_
                                    # device_count=4 for --multi-gpu);
                                    # skips (b), never prints the result
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")

# full-SLAM bar against the renderer's ground truth
ATE_MAX_M = 0.05
# VO parity between backends: both run the same f32 program, so the per-frame
# poses differ only through summation order (detector scores, fits). One
# correspondence entering or leaving an inlier set of hundreds moves the
# least-squares fit by well under a millimetre at 1-4 m depth; these bounds
# are that, with margin.
VO_TRANS_TOL_M = 2e-3
VO_ROT_TOL_DEG = 0.1
TOUR_FRAMES = 128
VO_FRAMES = 16

COMPILE_S = [0.0]


def _on_duration(event: str, secs: float, **_kw) -> None:
    if event.startswith("/jax/core/compile/"):
        COMPILE_S[0] += secs


def phase(name):
    """Print a phase's wall and compile seconds when it returns."""
    def wrap(fn):
        def run(*args, **kw):
            c0, t0 = COMPILE_S[0], time.perf_counter()
            out = fn(*args, **kw)
            print(f"[{name}] done in {time.perf_counter() - t0:.1f} s "
                  f"(compile {COMPILE_S[0] - c0:.1f} s)", flush=True)
            return out
        return run
    return wrap


def fail(msg: str):
    raise RuntimeError(msg)


@phase("a: device")
def device_check(jax, rehearsal: bool):
    dev = jax.devices()[0]
    want = "cpu" if rehearsal else "gpu"
    if dev.platform != want:
        fail(f"JAX's first device is {dev.platform!r}, not {want!r}")
    print(f"devices: {len(jax.devices())} x {dev.device_kind} "
          f"({dev.platform})")
    if not rehearsal:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60)
        for line in smi.stdout.strip().splitlines():
            print(f"nvidia-smi: {line}")
    return dev


class _Tally:
    """pytest plugin: counts test outcomes."""

    def __init__(self):
        self.outcomes = []

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.outcomes.append((report.nodeid, report.outcome))


@phase("b: kernel parity")
def kernel_parity():
    import pytest

    tally = _Tally()
    rc = pytest.main(["-q", "-s", "-p", "no:cacheprovider", "-m", "gpu",
                      os.path.join(ROOT, "tests", "test_gpu_kernels.py")],
                     plugins=[tally])
    bad = [o for o in tally.outcomes if o[1] != "passed"]
    if rc != 0 or bad or not tally.outcomes:
        fail(f"kernel parity: pytest rc {rc}, not passed: {bad}")
    print(f"kernel parity: {len(tally.outcomes)} tests passed")


def _rot_deg(Ra, Rb):
    import numpy as np

    c = (np.trace(Ra.T @ Rb) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


@phase("c: VO step vs CPU")
def vo_vs_cpu(jax, dev):
    import numpy as np

    import __graft_entry__
    from rgbdslam.io.synthetic import SyntheticDataset

    step, example = __graft_entry__.entry()
    ds = SyntheticDataset(n_frames=TOUR_FRAMES, trajectory="tour")
    frames = [tuple(np.asarray(x) for x in ds.grab(i)[1:])
              for i in range(VO_FRAMES + 1)]

    def run_on(device):
        with jax.default_device(device):
            fn = jax.jit(step)
            out = []
            for i in range(VO_FRAMES):
                args = (*frames[i], *frames[i + 1], jax.random.PRNGKey(i))
                args = jax.device_put(args, device)
                T21, ninl, rmse = fn(*args)
                out.append((np.asarray(T21), int(ninl)))
            mem = fn.lower(*jax.device_put(example, device)) \
                .compile().memory_analysis()
        return out, mem

    dev_out, mem = run_on(dev)
    print(f"VO step memory_analysis on {dev.device_kind}: {mem}")
    cpu_out, _ = run_on(jax.devices("cpu")[0])
    dt = [float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
          for (a, _), (b, _) in zip(dev_out, cpu_out)]
    dr = [_rot_deg(a[:3, :3], b[:3, :3])
          for (a, _), (b, _) in zip(dev_out, cpu_out)]
    inl = [(a[1], b[1]) for a, b in zip(dev_out, cpu_out)]
    print(f"VO {VO_FRAMES} frames: max |dt| {max(dt):.3g} m "
          f"(tol {VO_TRANS_TOL_M}), max |dR| {max(dr):.3g} deg "
          f"(tol {VO_ROT_TOL_DEG}); inliers device/cpu {inl}")
    if max(dt) > VO_TRANS_TOL_M or max(dr) > VO_ROT_TOL_DEG:
        fail("VO step differs from the CPU backend beyond tolerance")


def _cli(argv):
    """Run the CLI in this process; returns its JSON result line."""
    from rgbdslam import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        fail(f"cli {argv} returned {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@phase("d: full SLAM")
def full_slam():
    for mode, extra in (("per-frame", []), ("batch 8", ["--batch", "8"])):
        c0, t0 = COMPILE_S[0], time.perf_counter()
        res = _cli(["--dataset", "synthetic:tour", "--frames",
                    str(TOUR_FRAMES), "--loop-interval", "12",
                    "--out-dir", os.path.join(OUT, mode.replace(" ", "")),
                    *extra])
        print(f"full SLAM {mode}: ATE {res['ate_rmse']} m, "
              f"{res['keyframes']} keyframes, {res['loops_closed']} loops, "
              f"{res['graph_edges']} graph edges, wall "
              f"{time.perf_counter() - t0:.1f} s incl. compile "
              f"{COMPILE_S[0] - c0:.1f} s", flush=True)
        if not res["ate_rmse"] <= ATE_MAX_M:
            fail(f"{mode}: ATE {res['ate_rmse']} > {ATE_MAX_M}")
        if res["keyframes"] < 2 or res["loops_closed"] < 1:
            fail(f"{mode}: no keyframes or no loop closure: {res}")


@phase("multi-gpu: distributed tour vs one device")
def multi_gpu(jax):
    import numpy as np

    import __graft_entry__
    from rgbdslam.config import LoopConfig, SlamConfig
    from rgbdslam.eval.ate import ate_rmse
    from rgbdslam.io.synthetic import SyntheticDataset
    from rgbdslam.loop.vocabulary import shipped_vocabulary
    from rgbdslam.slam.system import SlamSystem

    n_dev = len(jax.devices())
    if n_dev != 4:
        fail(f"--multi-gpu needs 4 devices, JAX sees {n_dev}")
    ds = SyntheticDataset(n_frames=TOUR_FRAMES, trajectory="tour")
    frames = [ds.grab(i) for i in range(TOUR_FRAMES)]

    def run(distributed):
        cfg = SlamConfig(loop=LoopConfig(id_interval=12),
                         distributed=distributed)
        system = SlamSystem(ds.cam, cfg)
        system.load_vocabulary(shipped_vocabulary(cfg.detector))
        for ts, gray, depth in frames:
            system.track(ts, gray, depth)
        system.finish()
        ts_c, poses = system.camera_trajectory()
        rmse, _ = ate_rmse(ts_c, poses, ds.timestamps, ds.poses_twc)
        return system, poses, rmse

    one, poses_1, ate_1 = run(False)
    dist, poses_d, ate_d = run(True)
    div = float(np.linalg.norm(poses_d[:, :3, 3] - poses_1[:, :3, 3],
                               axis=-1).max())
    print(f"distributed over {dist._mesh.size} devices: ATE {ate_d:.4f} m, "
          f"{dist.loops_closed} loops, {dist.graph.dist_solves} mesh solves; "
          f"one device: ATE {ate_1:.4f} m, {one.loops_closed} loops; "
          f"max pose divergence {div:.4f} m")
    # tolerances of tests/test_distributed_system.py
    if not (dist.graph.dist_solves >= 1 and dist.loops_closed >= 1
            and ate_1 < 0.10 and ate_d < 0.10 and div < 0.05):
        fail("distributed run does not match the one-device run")
    __graft_entry__.dryrun_multichip(4)
    print("dryrun_multichip(4): ok")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi-gpu", action="store_true",
                    help="run only the 4-device distributed path")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run on the CPU backend; never prints the result")
    args = ap.parse_args()

    os.environ.setdefault("JAX_PLATFORMS",
                          "cpu" if args.cpu_rehearsal else "cuda,cpu")
    import jax

    import rgbdslam  # noqa: F401  (float32 matmul precision)
    from rgbdslam.utils.compile_cache import enable_compile_cache

    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    dev = device_check(jax, args.cpu_rehearsal)
    print(f"compile cache: {enable_compile_cache()}")
    if args.multi_gpu:
        multi_gpu(jax)
    else:
        if args.cpu_rehearsal:
            print("[b: kernel parity] skipped on the CPU")
        else:
            kernel_parity()
        vo_vs_cpu(jax, dev)
        full_slam()
    print(f"total compile {COMPILE_S[0]:.1f} s")
    if args.cpu_rehearsal:
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
