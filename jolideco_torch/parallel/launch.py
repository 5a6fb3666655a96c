"""Run a function on several local ranks of one process group.

``torchrun --nproc-per-node N`` is the way to start a multi-GPU run; this
is the in-process counterpart, for tests, smoke runs and examples:
:func:`run_ranks` spawns ``N`` processes, each joins a process group over
a ``FileStore`` and calls ``fn(rank, world_size, *args)``, and the
results come back in rank order. A rank that raises or dies, or a group
that outlives ``timeout``, fails the call within seconds: the other
ranks, which would otherwise wait in a collective for ever, are killed.
Every collective of the group also times out after ``collective_timeout``
seconds.
"""

import multiprocessing
import queue
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path

__all__ = ["run_ranks"]


def _rank_main(fn, rank, world_size, args, backend, store_path,
               collective_timeout, threads, results):
    import torch
    import torch.distributed as dist

    if threads is not None:
        torch.set_num_threads(threads)
    try:
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world_size,
            timeout=timedelta(seconds=collective_timeout))
        try:
            results.put((rank, True, fn(rank, world_size, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world_size, args=(), backend="gloo", timeout=300.0,
              collective_timeout=60.0, threads=None):
    """``[fn(rank, world_size, *args) for rank in range(world_size)]``,
    each call in its own spawned process, all in one process group.

    ``fn`` must be importable by name (a module-level function) and its
    arguments and result picklable. ``backend`` is ``"gloo"`` (CPU
    tensors, or CUDA tensors of several ranks sharing a card) or
    ``"nccl"`` (one card per rank). ``threads`` sets each rank's
    ``torch.set_num_threads``. Raises ``RuntimeError`` with the failing
    rank's traceback, or ``TimeoutError``; the processes are gone when
    it returns or raises.
    """
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as folder:
        store_path = str(Path(folder) / "store")
        procs = [
            ctx.Process(target=_rank_main, daemon=True, args=(
                fn, rank, world_size, tuple(args), backend, store_path,
                collective_timeout, threads, results))
            for rank in range(world_size)
        ]
        for proc in procs:
            proc.start()
        try:
            return _collect(procs, results, world_size, timeout)
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
            for proc in procs:
                proc.join(10.0)
            results.close()


def _collect(procs, results, world_size, timeout):
    """The ranks' results in rank order; raises on the first failure,
    with every failure reported within a second of it (a rank's fault
    makes the others' collectives fail too)."""
    deadline = time.monotonic() + timeout
    done, failed = {}, {}
    while len(done) < world_size:
        try:
            rank, ok, value = results.get(timeout=0.2)
        except queue.Empty:
            if time.monotonic() > deadline:
                if failed:
                    break
                missing = sorted(set(range(world_size)) - set(done))
                raise TimeoutError(f"run_ranks: ranks {missing} did not "
                                   f"finish within {timeout} s") from None
            for rank, proc in enumerate(procs):
                if (rank not in done and rank not in failed
                        and proc.exitcode not in (None, 0)):
                    failed[rank] = (f"died (exit code {proc.exitcode}) "
                                    "without a result")
                    deadline = min(deadline, time.monotonic() + 1.0)
            continue
        if ok:
            done[rank] = value
        else:
            failed[rank] = f"failed:\n{value}"
            deadline = min(deadline, time.monotonic() + 1.0)
    if failed:
        raise RuntimeError("\n".join(f"run_ranks: rank {rank} {message}"
                                     for rank, message in sorted(
                                         failed.items())))
    return [done[rank] for rank in range(world_size)]
