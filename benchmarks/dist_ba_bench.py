"""Distributed pose-graph BA scaling harness.

Measures Gauss-Newton iterations/s of the edge-sharded distributed optimizers
(parallel/dist_ba.py) across mesh sizes, for both solve variants:

- `dense`: psum-reduced dense (6K)^2 normal equations + replicated Cholesky.
  Communication per GN iteration: one all-reduce of 36K^2 + 6K f32
  (~4.7 MB at K=512) — O(K^2) wire cost, does not scale past ~1k keyframes.
- `cg`: matrix-free block-Jacobi CG (solvers/cg.py sharded). Communication
  per GN iteration: one (K,6,6) psum (preconditioner, 144K bytes) + one
  (K,6) psum (gradient) + cg_iters x one (K,6) psum (matvecs, 24K bytes
  each) — O(K) wire cost, the variant that scales with map size.

On a multi-GPU host this measures real NVLink scaling; on the CPU
`--virtual N` mesh it validates the SPMD program and gives a lower-bound
sanity check (virtual devices share host cores, so virtual "scaling"
understates real hardware — BASELINE.md's >=70%-at-2-hosts target needs
several hosts to measure).

`--processes N` instead launches N separate OS processes (4 virtual devices
each) joined via jax.distributed + gloo — the true multi-host code path
(rgbdslam/parallel/multihost.py) with real process-boundary collectives.

Usage:
  python benchmarks/dist_ba_bench.py --devices 1 2 4 8 --virtual 8
  python benchmarks/dist_ba_bench.py --processes 2
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_multiprocess(num_processes: int, vertices: int, edges: int,
                     iterations: int, reps: int):
    """Launch N multihost workers (jax.distributed over gloo) and report
    process-0's measured GN iters/s."""
    import socket
    import subprocess

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for pid in range(num_processes):
        cmd = [
            sys.executable, "-m", "rgbdslam.parallel.multihost",
            "--coordinator", f"localhost:{port}",
            "--num-processes", str(num_processes),
            "--process-id", str(pid),
            "--devices-per-process", "4",
            "--vertices", str(vertices), "--edges", str(edges),
            "--iterations", str(iterations),
            "--bench-reps", str(reps),
        ]
        procs.append(subprocess.Popen(cmd, cwd=repo, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        if p.returncode != 0:
            print(err[-2000:], file=sys.stderr)
            raise RuntimeError("multihost worker failed")
        outs.append(json.loads(
            [l for l in out.splitlines() if l.startswith("{")][-1]))
    print(json.dumps({
        "metric": "dist_ba_multiprocess",
        "processes": num_processes,
        "global_devices": outs[0]["global_devices"],
        "vertices": vertices, "edges": edges,
        "gn_iters_per_s": outs[0].get("gn_iters_per_s"),
        "caveat": (
            f"{num_processes} OS processes x 4 virtual CPU devices sharing "
            f"{os.cpu_count()} host cores — validates the multi-host code "
            "path (gloo collectives across process boundaries); wall-clock "
            "scaling on shared cores UNDERSTATES real pod-slice hardware"
        ),
    }))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--virtual", type=int, default=0,
                    help="force N virtual CPU devices (0 = use real devices)")
    ap.add_argument("--processes", type=int, default=0,
                    help="multi-process mode: N OS processes x 4 devices")
    ap.add_argument("--vertices", type=int, default=256)
    ap.add_argument("--edges", type=int, default=4096)
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--cg-iters", type=int, default=64)
    ap.add_argument("--solver", choices=["dense", "cg", "both"],
                    default="both")
    args = ap.parse_args()

    if args.processes:
        run_multiprocess(args.processes, args.vertices, args.edges,
                         args.iterations, reps=3)
        return

    if args.virtual:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.virtual}"
        ).strip()
        import jax

        jax.config.update("jax_platforms", "cpu")
    else:
        import jax

    import jax.numpy as jnp
    import numpy as np

    from rgbdslam.geometry import se3
    from rgbdslam.parallel.dist_ba import (
        distributed_pose_graph_optimize,
        distributed_pose_graph_optimize_cg,
        make_mesh,
        shard_edges,
    )
    from rgbdslam.solvers.pose_graph import PoseGraphEdges

    K, E = args.vertices, args.edges
    rng = np.random.default_rng(0)
    xi = rng.normal(scale=0.1, size=(K, 6)).astype(np.float32)
    Twc = np.asarray(se3.exp(jnp.asarray(xi)))
    a = rng.integers(1, K, size=E).astype(np.int32)
    b = np.maximum(a - rng.integers(1, 8, size=E), 0).astype(np.int32)
    Z = np.stack([np.linalg.inv(Twc[i]) @ Twc[j] for i, j in zip(a, b)]).astype(np.float32)
    edges = PoseGraphEdges(
        a=jnp.asarray(a), b=jnp.asarray(b), Z=jnp.asarray(Z),
        weight=jnp.full((E,), 100.0, jnp.float32),
    )
    fixed = jnp.zeros((K,), bool).at[0].set(True)

    solvers = {}
    if args.solver in ("dense", "both"):
        solvers["dense"] = lambda T, ed, f, m: distributed_pose_graph_optimize(
            T, ed, f, m, args.iterations)
    if args.solver in ("cg", "both"):
        solvers["cg"] = lambda T, ed, f, m: distributed_pose_graph_optimize_cg(
            T, ed, f, m, args.iterations, args.cg_iters)

    results = {name: {} for name in solvers}
    for name, solve in solvers.items():
        t1 = None
        for n_dev in args.devices:
            if n_dev > jax.device_count():
                print(f"skip {n_dev} devices (only {jax.device_count()})",
                      file=sys.stderr)
                continue
            mesh = make_mesh(n_dev)
            ed = shard_edges(edges, mesh)
            # warmup/compile
            out = solve(jnp.asarray(Twc), ed, fixed, mesh)
            jax.block_until_ready(out)
            t0 = time.perf_counter()
            reps = 5
            for _ in range(reps):
                out = solve(jnp.asarray(Twc), ed, fixed, mesh)
            jax.block_until_ready(out)
            dt = (time.perf_counter() - t0) / reps
            iters_per_s = args.iterations / dt
            if t1 is None:
                t1 = dt
            eff = t1 / (dt * n_dev)
            results[name][n_dev] = {"iters_per_s": round(iters_per_s, 2),
                                    "scaling_eff": round(eff, 3)}
            print(f"[{name}] devices={n_dev:2d}: {iters_per_s:8.2f} GN iters/s "
                  f"(eff {eff:.2f})", file=sys.stderr)

    out = {
        "metric": "dist_ba_iters_per_s",
        "vertices": K, "edges": E,
        "comm_per_gn_iter_bytes": {
            "dense": 4 * (36 * K * K + 6 * K),
            "cg": 4 * (36 * K + 6 * K + args.cg_iters * 6 * K),
        },
        "results": results,
    }
    if args.virtual:
        out["caveat"] = (
            f"{args.virtual} virtual CPU devices share {os.cpu_count()} host "
            "cores: scaling_eff here is a program-validity check, not a "
            "hardware scaling measurement — it UNDERSTATES real multi-GPU "
            "scaling by construction (BASELINE.md's >=70%-at-2-hosts target "
            "needs two hosts)"
        )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
