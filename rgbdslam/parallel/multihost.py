"""Multi-host / multi-process distribution for the SLAM backend.

The reference is a single-process system (SURVEY.md §2.7: its only
"communication backend" is ~20 mutexes and one keyframe queue); this module
is the multi-host scaling axis the reference lacks (§2.7 P7): each host runs
`jax.distributed.initialize` against a coordination service, the pose-graph
edge set (and BA landmark set) is sharded over the *global* device mesh, and
the Gauss-Newton reductions ride the collectives — ICI within a host's chips,
DCN across hosts. The same program runs unchanged on real GPU hosts or on N
CPU processes with virtual devices (how tests/test_multiprocess.py and
benchmarks/dist_ba_bench.py --processes exercise it on this machine; CPU
cross-process collectives go through gloo, JAX's default).

Per-device state is O(K + E/n): replicated pose vectors, an edge shard, and
the O(K) CG vectors — never a (6K)^2 matrix (see
parallel/dist_ba.distributed_pose_graph_optimize_cg for the wire-cost
accounting).

Run as a module, this file is the per-process worker used by the
multi-process test and benchmark:

  python -m rgbdslam.parallel.multihost \
      --coordinator localhost:9755 --num-processes 2 --process-id $i \
      --devices-per-process 4 --vertices 64 --edges 256 --check
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def local_card_ids(process_id: int, processes_per_host: int):
    """Local cards a process of a GPU job opens.

    Process ids are numbered host by host: host h runs ids
    h*P .. h*P + P - 1 for P = processes_per_host. With one process per
    host (P = 1) the answer is None, i.e. every card of the host. With one
    process per card (P = cards per host) it is the one card
    [process_id % P], so no two processes reserve memory on the same card.
    """
    if processes_per_host < 1:
        raise ValueError(f"processes_per_host={processes_per_host} < 1")
    if processes_per_host == 1:
        return None
    return [process_id % processes_per_host]


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               platform: str | None = None,
               devices_per_process: int | None = None,
               processes_per_host: int = 1):
    """Bring up the JAX distributed runtime for one process of a multi-host
    job. Call before any other JAX API touches a backend.

    platform="cpu" + devices_per_process=N gives N virtual CPU devices per
    process (the test/bench configuration). On GPU hosts leave both None and
    give processes_per_host: 1 (the default) opens every card of the host,
    the card count (one process per card) opens only this process's card
    (local_card_ids).
    """
    if devices_per_process is not None:
        # drop any inherited device-count flag (e.g. from a parent test
        # runner) before pinning ours
        flags = [
            f for f in os.environ.get("XLA_FLAGS", "").split()
            if "xla_force_host_platform_device_count" not in f
        ]
        flags.append(
            f"--xla_force_host_platform_device_count={devices_per_process}"
        )
        os.environ["XLA_FLAGS"] = " ".join(flags)
    import jax

    if platform is not None:
        # the config update wins over an inherited JAX_PLATFORMS
        jax.config.update("jax_platforms", platform)
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_card_ids(process_id, processes_per_host),
    )
    return jax


def global_mesh(axis: str = "edges"):
    """1-D mesh over every device of every process."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis,))


def make_global(x, mesh, spec):
    """Build a global jax.Array from a host copy of the *full* value.

    Every process holds the same full array (SLAM state is deterministically
    replicated on the hosts); each contributes only its addressable shards.
    Works identically in single-process mode, so callers don't branch.
    """
    import jax
    from jax.sharding import NamedSharding

    x = np.asarray(x)
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(x.shape, sharding, lambda idx: x[idx])


def shard_edges_global(edges, mesh, axis: str = "edges"):
    """Multi-process counterpart of dist_ba.shard_edges: pad E to a multiple
    of the global device count, shard on `axis` via make_global (padding
    slots have weight 0 → no effect on the solve)."""
    from jax.sharding import PartitionSpec as P

    from rgbdslam.solvers.pose_graph import PoseGraphEdges

    n_dev = mesh.shape[axis]
    a = np.asarray(edges.a)
    E = a.shape[0]
    Ep = ((E + n_dev - 1) // n_dev) * n_dev
    pad = Ep - E
    Z = np.asarray(edges.Z)
    if pad:
        a = np.concatenate([a, np.zeros(pad, a.dtype)])
        b = np.concatenate([np.asarray(edges.b), np.zeros(pad, a.dtype)])
        Z = np.concatenate([Z, np.tile(np.eye(4, dtype=Z.dtype), (pad, 1, 1))])
        w = np.concatenate(
            [np.asarray(edges.weight), np.zeros(pad, np.float32)]
        )
    else:
        b, w = np.asarray(edges.b), np.asarray(edges.weight)
    return PoseGraphEdges(
        a=make_global(a, mesh, P(axis)),
        b=make_global(b, mesh, P(axis)),
        Z=make_global(Z, mesh, P(axis)),
        weight=make_global(w, mesh, P(axis)),
    )


def fetch_replicated(x) -> np.ndarray:
    """Host copy of a fully-replicated global array (each process reads its
    local replica — no cross-process transfer)."""
    return np.asarray(x.addressable_data(0))


# ---------------------------------------------------------------------------
# Asynchronous loop-constraint exchange over DCN (SURVEY §2.7 P7)
# ---------------------------------------------------------------------------


class ConstraintExchange:
    """Fire-and-forget exchange of loop-closure constraints between hosts.

    The solve itself rides synchronous collectives (ICI); loop constraints
    are discovered asynchronously by whichever host's tracker finds them and
    must reach the other hosts WITHOUT a barrier — the reference's analog is
    the PoseGraph thread consuming the tracker's queue across a thread
    boundary (Solver/PoseGraph.cpp:289-302); across machines the boundary is
    DCN. Plain length-prefixed TCP with a listener thread per process: no
    collective, no rendezvous — publish() never blocks on the consumer, and
    poll() drains whatever has arrived before the next solve.

    Wire format per edge: fixed 80-byte payload
    [sender i32 | a i32 | b i32 | weight f32 | Z 16xf32] — the sender id
    keys receiver-side dedup (two hosts may legitimately discover
    constraints with identical content).
    """

    _EDGE_BYTES = 4 + 4 + 4 + 4 + 64

    def __init__(self, port: int, peers, sender: int = 0):
        import socket
        import threading

        self._sender = int(sender)
        self._peers = list(peers)          # "host:port" of every OTHER process
        self._rx = []
        self._lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("0.0.0.0", port))
        self._sock.listen(8)
        self._closing = False
        self._conns = {}
        self._thread = threading.Thread(target=self._listen, daemon=True)
        self._thread.start()

    # -- receive side ---------------------------------------------------
    def _listen(self):
        import threading

        while not self._closing:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._drain, args=(conn,),
                             daemon=True).start()

    def _drain(self, conn):
        import numpy as _np

        buf = b""
        while not self._closing:
            try:
                chunk = conn.recv(4096)
            except OSError:
                return
            if not chunk:
                return
            buf += chunk
            while len(buf) >= self._EDGE_BYTES:
                rec, buf = buf[: self._EDGE_BYTES], buf[self._EDGE_BYTES:]
                snd = int(_np.frombuffer(rec[0:4], _np.int32)[0])
                a = int(_np.frombuffer(rec[4:8], _np.int32)[0])
                b = int(_np.frombuffer(rec[8:12], _np.int32)[0])
                w = float(_np.frombuffer(rec[12:16], _np.float32)[0])
                Z = _np.frombuffer(rec[16:], _np.float32).reshape(4, 4).copy()
                with self._lock:
                    self._rx.append((snd, a, b, Z, w))

    # -- send side --------------------------------------------------------
    def _conn_to(self, peer: str):
        import socket

        if peer not in self._conns:
            host, port = peer.rsplit(":", 1)
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.settimeout(5.0)
            s.connect((host, int(port)))
            self._conns[peer] = s
        return self._conns[peer]

    def publish(self, a: int, b: int, Z: np.ndarray, weight: float = 1.0):
        """Ship one constraint to every peer; best-effort (a dead peer is
        skipped — elastic, like any DCN-side channel must be)."""
        rec = (np.int32(self._sender).tobytes()
               + np.int32(a).tobytes() + np.int32(b).tobytes()
               + np.float32(weight).tobytes()
               + np.asarray(Z, np.float32).tobytes())
        for peer in self._peers:
            try:
                self._conn_to(peer).sendall(rec)
            except OSError:
                self._conns.pop(peer, None)

    def poll(self):
        """Drain constraints received since the last poll (non-blocking)."""
        with self._lock:
            out, self._rx = self._rx, []
        return out

    def close(self):
        self._closing = True
        try:
            self._sock.close()
        except OSError:
            pass
        for s in self._conns.values():
            try:
                s.close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# Worker: deterministic distributed pose-graph solve + self-check/bench
# ---------------------------------------------------------------------------


def _make_problem(K: int, E: int, seed: int = 0):
    """Deterministic noisy pose-graph problem (identical on every process):
    a perturbed chain with random skip edges, measurements from the
    ground-truth poses, initial guess from the perturbed ones."""
    rng = np.random.default_rng(seed)
    import jax.numpy as jnp

    from rgbdslam.geometry import se3

    xi_true = rng.normal(scale=0.2, size=(K, 6)).astype(np.float32)
    xi_true[0] = 0
    Twc_true = np.asarray(se3.exp(jnp.asarray(xi_true)))
    a = np.concatenate(
        [np.arange(1, K), rng.integers(2, K, size=max(E - (K - 1), 0))]
    ).astype(np.int32)
    b = np.concatenate(
        [np.arange(0, K - 1),
         np.maximum(a[K - 1:] - rng.integers(2, 10, size=a.shape[0] - (K - 1)), 0)]
    ).astype(np.int32)
    Z = np.stack(
        [np.linalg.inv(Twc_true[i]) @ Twc_true[j] for i, j in zip(a, b)]
    ).astype(np.float32)
    xi0 = xi_true + rng.normal(scale=0.05, size=(K, 6)).astype(np.float32)
    xi0[0] = 0
    Twc0 = np.asarray(se3.exp(jnp.asarray(xi0)))
    from rgbdslam.solvers.pose_graph import PoseGraphEdges

    edges = PoseGraphEdges(
        a=a, b=b, Z=Z, weight=np.full(a.shape, 100.0, np.float32)
    )
    fixed = np.zeros((K,), bool)
    fixed[0] = True
    return Twc0, edges, fixed, Twc_true


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default="localhost:9755")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--devices-per-process", type=int, default=4)
    ap.add_argument("--platform", default="cpu")
    ap.add_argument("--processes-per-host", type=int, default=1,
                    help="GPU hosts: 1 opens every card of the host, the "
                         "card count opens one card per process")
    ap.add_argument("--vertices", type=int, default=64)
    ap.add_argument("--edges", type=int, default=256)
    ap.add_argument("--iterations", type=int, default=8)
    ap.add_argument("--cg-iters", type=int, default=64)
    ap.add_argument("--check", action="store_true",
                    help="compare against the local dense solve")
    ap.add_argument("--bench-reps", type=int, default=0,
                    help="time the solve over N repetitions")
    ap.add_argument("--exchange-base-port", type=int, default=0,
                    help="exercise the async DCN loop-constraint exchange: "
                         "each process withholds one loop edge, publishes it "
                         "over TCP, and solves only after receiving the "
                         "peers' constraints")
    args = ap.parse_args(argv)

    jax = initialize(
        args.coordinator, args.num_processes, args.process_id,
        platform=args.platform,
        devices_per_process=args.devices_per_process,
        processes_per_host=args.processes_per_host,
    )
    import time

    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from rgbdslam.parallel.dist_ba import (
        distributed_pose_graph_optimize_cg,
    )

    assert jax.process_count() == args.num_processes
    mesh = global_mesh()
    K, E = args.vertices, args.edges
    Twc0, edges_np, fixed_np, Twc_true = _make_problem(K, E)

    exchanged = 0
    if args.exchange_base_port:
        # asynchronous DCN constraint exchange: the last `num_processes`
        # edges of the problem are "loop discoveries", one per process —
        # each is published over TCP and everyone merges before solving
        nproc = args.num_processes
        pid = args.process_id
        ex = ConstraintExchange(
            args.exchange_base_port + pid,
            [f"localhost:{args.exchange_base_port + p}"
             for p in range(nproc) if p != pid],
            sender=pid,
        )
        mine = E - nproc + pid
        received = {}
        acks = set()
        deadline = time.time() + 90.0
        last_pub = 0.0
        # single drive loop over the best-effort channel: keep re-publishing
        # our constraint (a peer whose listener wasn't up yet just dropped
        # it; duplicates dedup by content); once we hold every peer's
        # constraint, start publishing an ack record (a = -1-pid), and only
        # finish when every peer has acked too — pure TCP choreography, no
        # collective (a gloo barrier here would poison the solve's own gloo
        # context; a real deployment never tears the channel down at all)
        while ((len(received) < nproc - 1 or len(acks) < nproc - 1)
               and time.time() < deadline):
            if time.time() - last_pub > 0.5:
                ex.publish(int(edges_np.a[mine]), int(edges_np.b[mine]),
                           edges_np.Z[mine], float(edges_np.weight[mine]))
                if len(received) == nproc - 1:
                    ex.publish(-1, 0, np.eye(4, dtype=np.float32), 0.0)
                last_pub = time.time()
            for (snd, a, b, Z, w) in ex.poll():
                if a < 0:
                    acks.add(snd)
                else:
                    # dedup by DISCOVERING PROCESS (two hosts may publish
                    # identical-content constraints; each still counts)
                    received[snd] = (a, b, Z, w)
            time.sleep(0.01)
        # final ack: the exit condition can be met between timer ticks,
        # before this process ever sent its own ack
        ex.publish(-1, 0, np.eye(4, dtype=np.float32), 0.0)
        for _ in range(100):   # drain any last in-flight acks
            if len(acks) >= nproc - 1:
                break
            for (snd, a, b, Z, w) in ex.poll():
                if a < 0:
                    acks.add(snd)
            time.sleep(0.01)
        ex.close()
        exchanged = len(received)
        assert exchanged == nproc - 1, f"got {exchanged} constraints"
        assert len(acks) == nproc - 1, f"got {len(acks)} acks"
        # reassemble the full edge set deterministically: base edges + every
        # process's discovery in index order — identical on all hosts
        from rgbdslam.solvers.pose_graph import PoseGraphEdges

        disc = {(int(edges_np.a[E - nproc + p]),
                 int(edges_np.b[E - nproc + p]))
                for p in range(nproc)}
        a_l = list(edges_np.a[: E - nproc])
        b_l = list(edges_np.b[: E - nproc])
        Z_l = list(edges_np.Z[: E - nproc])
        w_l = list(edges_np.weight[: E - nproc])
        received[pid] = (int(edges_np.a[mine]), int(edges_np.b[mine]),
                         edges_np.Z[mine].astype(np.float32),
                         float(edges_np.weight[mine]))
        for snd in sorted(received):
            a, b, Z, w = received[snd]
            assert (a, b) in disc
            a_l.append(a)
            b_l.append(b)
            Z_l.append(Z)
            w_l.append(w)
        edges_np = PoseGraphEdges(
            a=np.asarray(a_l, np.int32), b=np.asarray(b_l, np.int32),
            Z=np.stack(Z_l).astype(np.float32),
            weight=np.asarray(w_l, np.float32),
        )

    edges = shard_edges_global(edges_np, mesh)
    Twc = make_global(Twc0, mesh, P())
    fixed = make_global(fixed_np, mesh, P())

    Twc_opt, cost = distributed_pose_graph_optimize_cg(
        Twc, edges, fixed, mesh, args.iterations, args.cg_iters
    )
    jax.block_until_ready(Twc_opt)
    out = fetch_replicated(Twc_opt)
    result = {
        "process_id": args.process_id,
        "processes": args.num_processes,
        "global_devices": jax.device_count(),
        "final_cost": float(fetch_replicated(cost)),
        "exchanged_constraints": exchanged,
    }

    # recovery check vs ground truth (measurements are noise-free, so the
    # optimum IS the ground truth up to the vertex-0 gauge)
    err_t = np.linalg.norm(out[:, :3, 3] - Twc_true[:, :3, 3], axis=-1)
    result["max_translation_err"] = float(err_t.max())

    if args.check:
        from rgbdslam.solvers.pose_graph import (PoseGraphEdges,
                                                 optimize_pose_graph)

        dense_edges = PoseGraphEdges(
            a=jnp.asarray(edges_np.a), b=jnp.asarray(edges_np.b),
            Z=jnp.asarray(edges_np.Z), weight=jnp.asarray(edges_np.weight),
        )
        Twc_dense, _ = optimize_pose_graph(
            jnp.asarray(Twc0), dense_edges, jnp.asarray(fixed_np),
            args.iterations,
        )
        diff = float(np.abs(out - np.asarray(Twc_dense)).max())
        result["max_diff_vs_dense"] = diff
        result["check_ok"] = bool(diff < 5e-3 and err_t.max() < 5e-3)

    if args.bench_reps:
        t0 = time.perf_counter()
        for _ in range(args.bench_reps):
            Twc_opt, cost = distributed_pose_graph_optimize_cg(
                Twc, edges, fixed, mesh, args.iterations, args.cg_iters
            )
        jax.block_until_ready(Twc_opt)
        dt = (time.perf_counter() - t0) / args.bench_reps
        result["gn_iters_per_s"] = round(args.iterations / dt, 2)

    # one JSON line per process; the launcher reads process 0's
    print(json.dumps(result))
    sys.stdout.flush()
    jax.distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
