#!/usr/bin/env python
"""Multi-process dryrun of the port's ``parallel/`` layer: real process
boundaries, simulated hosts, no cluster and no card.

The port's counterpart of ``scripts/dryrun_multihost.py``:

  parent: spawns ``--processes`` gloo CPU ranks, grouped ``--local-ranks``
          per simulated host (``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` as
          torchrun sets them).
  worker: ``initialize_distributed`` against the parent-chosen coordinator
          -> ``make_multihost_mesh`` (the model dim inside a host) ->
          cross-rank sum check -> one ``ShardedHeadTrainer`` step (data
          parallel across hosts, tensor parallel inside one) -> the
          classifier's streamed ``partial_fit`` on the mesh and its
          resident training (row-sharded buffer, f32 and int8), each held
          against a mesh-less run of the same data: losses within 1e-5,
          probabilities within rtol 1e-5 / atol 1e-6.

Exit 0 only when every worker succeeds, with the OK marker printed. Run:

    python -m mermaid_classifier_tpu_torch.scripts.dryrun_multihost \\
        [--processes 4] [--local-ranks 2] [--timeout 240]
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

if not __package__:
    # Run as a file (the parent starts its workers so): the repository
    # root onto the path, as ``-m`` from the root would have it.
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

OK_MARKER = "MULTIHOST_DRYRUN_OK"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _check_against_local(mesh, n_total: int) -> str:
    """The classifier's mesh paths against mesh-less runs of the same
    global data (every rank draws the same seeded stream)."""
    import numpy as np

    from mermaid_classifier_tpu_torch.train.mlp_classifier import MLPClassifier

    def pair():
        kw = dict(learning_rate_init=1e-3, random_state=0,
                  batch_size=2 * n_total + 1, device="cpu")
        return (MLPClassifier((8,), mesh=mesh, **kw), MLPClassifier((8,), **kw))

    rng = np.random.default_rng(0)
    Xc = rng.standard_normal((4 * n_total + 3, 6)).astype(np.float32)
    yc = np.asarray([f"c{v}" for v in rng.integers(0, 3, len(Xc))])
    classes = sorted(set(yc.tolist()))
    meshed, local = pair()
    meshed.partial_fit(Xc, yc, classes=classes)
    local.partial_fit(Xc, yc, classes=classes)
    if not abs(meshed.loss_curve_[-1] - local.loss_curve_[-1]) < 1e-5:
        raise AssertionError(("stream", meshed.loss_curve_, local.loss_curve_))
    np.testing.assert_allclose(meshed.predict_proba(Xc), local.predict_proba(Xc),
                               rtol=1e-5, atol=1e-6)
    rng_r = np.random.default_rng(42)
    # A row count no rank count divides: the buffer pads.
    Xr = rng_r.standard_normal((6 * n_total + 1, 6)).astype(np.float32)
    yr = np.asarray([f"c{v}" for v in rng_r.integers(0, 3, len(Xr))])
    idx = np.arange(len(Xr))
    for rdtype in ("float32", "int8"):
        meshed, local = pair()
        meshed.set_resident_features(Xr, dtype=rdtype)
        local.set_resident_features(Xr, dtype=rdtype)
        for clf in (meshed, local):
            clf.partial_fit_resident(idx, yr, classes=sorted(set(yr.tolist())))
        r_loss, l_loss = meshed.loss_curve_[-1], local.loss_curve_[-1]
        if not (np.isfinite(r_loss) and abs(r_loss - l_loss) < 1e-5):
            raise AssertionError((rdtype, r_loss, l_loss))
        np.testing.assert_allclose(meshed.predict_proba_resident(idx),
                                   local.predict_proba_resident(idx),
                                   rtol=1e-5, atol=1e-6)
    return f"clf_loss={meshed.loss_curve_[-1]:.4f} resident=ok(f32,int8)"


def worker(args) -> int:
    import numpy as np
    import torch
    import torch.distributed as dist

    from mermaid_classifier_tpu_torch.parallel.mesh import (
        initialize_distributed,
        make_multihost_mesh,
    )
    from mermaid_classifier_tpu_torch.parallel.sharded_train import (
        ShardedHeadTrainer,
    )

    torch.set_num_threads(1)
    initialize_distributed(args.coordinator, args.processes, args.process_id,
                           device="cpu")
    try:
        n_total = args.processes
        if dist.get_world_size() != n_total:
            raise AssertionError(f"world size {dist.get_world_size()} != {n_total}")
        mesh = make_multihost_mesh(device="cpu")
        if mesh.size != n_total:
            raise AssertionError(f"mesh of {mesh.size} ranks, want {n_total}")
        # Cross-rank sum: every rank of every host must be seen.
        ones = torch.ones(1)
        dist.all_reduce(ones)
        if float(ones) != float(n_total):
            raise AssertionError(f"sum over the mesh gave {float(ones)}")

        # One sharded head-training step: the data-parallel gradient sum
        # crosses the simulated hosts, the model group stays inside one.
        layers = (16, 8, 4)
        batch = 4 * n_total
        trainer = ShardedHeadTrainer(mesh, layers, learning_rate=1e-3, alpha=0.01)
        params = trainer.init_params(seed=0)
        opt_state = trainer.init_opt_state(params)
        rng = np.random.default_rng(0)  # the same global batch on every rank
        x = rng.standard_normal((batch, layers[0])).astype(np.float32)
        y = rng.integers(0, layers[-1], size=batch)
        w = np.ones(batch, np.float32)
        params, opt_state, loss = trainer.train_step(
            params, opt_state, *trainer.place_batch(x, y, w), float(batch))
        if not np.isfinite(loss):
            raise AssertionError(loss)
        summary = _check_against_local(mesh, n_total)
        print(f"{OK_MARKER} process={args.process_id} mesh={mesh.shape}"
              f" loss={loss:.4f} {summary}", flush=True)
        return 0
    finally:
        dist.destroy_process_group()


def parent(args) -> int:
    if args.processes % args.local_ranks:
        raise SystemExit(f"--local-ranks {args.local_ranks} must divide"
                         f" --processes {args.processes}")
    port = _free_port()
    # Workers write to files, not pipes: a worker stuck in a collective
    # while another floods a full pipe would deadlock both, and files
    # survive a kill. args.timeout is one shared deadline for all of them
    # (a hung collective hangs every worker at once).
    procs: list[subprocess.Popen] = []
    logs = []
    failures = 0
    try:
        for rank in range(args.processes):
            log = tempfile.NamedTemporaryFile(
                "w+", prefix=f"multihost_w{rank}_", suffix=".log", delete=False)
            logs.append(log)
            env = dict(os.environ)
            env.update(LOCAL_RANK=str(rank % args.local_ranks),
                       LOCAL_WORLD_SIZE=str(args.local_ranks),
                       OMP_NUM_THREADS="1")
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--worker",
                 "--coordinator", f"127.0.0.1:{port}",
                 "--processes", str(args.processes),
                 "--process-id", str(rank)],
                env=env, stdout=log, stderr=subprocess.STDOUT,
            ))
        deadline = time.monotonic() + args.timeout
        timed_out = []
        for rank, proc in enumerate(procs):
            try:
                proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                timed_out.append(rank)
                for other in procs:
                    if other.poll() is None:
                        other.kill()
                        other.wait()
        for rank, proc in enumerate(procs):
            out = Path(logs[rank].name).read_text()
            ok = rank not in timed_out and proc.returncode == 0 and OK_MARKER in out
            state = (f"TIMEOUT after {args.timeout}s (shared deadline)"
                     if rank in timed_out else f"rc={proc.returncode}")
            print(f"worker {rank}: {state} {'ok' if ok else 'FAILED'}")
            if not ok:
                failures += 1
                print("--- worker output (tail) ---")
                print(out[-4000:])
    finally:
        # Never orphan workers or their log files, whatever raised above.
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs:
            log.close()
            Path(log.name).unlink(missing_ok=True)
    if failures:
        return 1
    print(f"{OK_MARKER}: {args.processes} processes, {args.local_ranks} per"
          " host: multi-host mesh, cross-rank sum, sharded train step, and"
          " streamed + resident training (f32 + int8 row-sharded buffer) equal"
          " to mesh-less runs")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--process-id", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--processes", type=int, default=4,
                        help="gloo CPU ranks in all (default 4)")
    parser.add_argument("--local-ranks", type=int, default=2,
                        help="ranks per simulated host (default 2)")
    parser.add_argument("--timeout", type=float, default=240.0,
                        help="one shared deadline for every worker, seconds")
    args = parser.parse_args(argv)
    if args.worker:
        return worker(args)
    return parent(args)


if __name__ == "__main__":
    raise SystemExit(main())
