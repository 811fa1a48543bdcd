"""Start a world of processes on one host, each a rank of a process
group: what ``torchrun --nproc_per_node N`` does, from inside a program
(the tests, entry.py's dry run and chip_smoke.py use it).

    results = run_world(fn, 4, workdir, args=(...,))

runs ``fn(rank, world_size, *args)`` in four spawned processes after
``init_process_group("gloo")`` and returns each rank's return value.  Under
``gloo`` the ranks may render on the CPU or share a card with CUDA tensors;
with ``backend="nccl"`` rank r owns card r (``torch.cuda.set_device``
before the group starts), so the host needs a card per rank.  ``fn`` must
be importable by its module path (a module-level function): a spawned
process starts from a fresh import, of the main script too.  The
rendezvous is a file in ``workdir``, so two worlds with two directories
never meet.
"""

from __future__ import annotations

import multiprocessing
import time
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist


def _rank_main(rank: int, world_size: int, workdir: str, timeout: float,
               fn, args, backend: str) -> None:
    # ranks share the host's cores: one thread each, or they spin against
    # each other
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        backend, init_method=f"file://{Path(workdir) / 'rendezvous'}",
        world_size=world_size, rank=rank, timeout=timedelta(seconds=timeout))
    try:
        out = fn(rank, world_size, *args)
        torch.save(out, Path(workdir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_world(fn, world_size: int, workdir, args=(),
              timeout: float = 300.0, backend: str = "gloo") -> list:
    """Run ``fn(rank, world_size, *args)`` on every rank of a new world of
    ``world_size`` spawned processes in a ``backend`` process group
    ("gloo" or "nccl") and return their results by rank.
    Raises TimeoutError when the world has not finished within ``timeout``
    seconds (its processes are ended) and RuntimeError when a rank
    failed."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    (workdir / "rendezvous").unlink(missing_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, str(workdir), timeout, fn,
                               args, backend))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if hung:
        raise TimeoutError(f"ranks {hung} of {world_size} still running "
                           f"after {timeout} s")
    failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode}
    if failed:
        raise RuntimeError(f"ranks failed (rank: exit code): {failed}")
    return [torch.load(workdir / f"rank{r}.pt") for r in range(world_size)]
