"""Ranks of ``torch.distributed`` on one host: the port's counterpart of
the eight virtual CPU devices the JAX tests run their meshes on.

``process_group`` opens and closes one rank's process group through a
``FileStore`` in a directory (no TCP port, so that several processes of
tests on one host never collide on one). ``spawn(fn, world, backend,
*args)`` starts ``world`` ranks; rank r calls ``fn(r, world, *args)``
inside its group, with one intra-op thread, and the caller gets back every
rank's result, its tensors as numpy arrays. ``fn`` must be importable by
name: each rank is a fresh interpreter (the ``spawn`` start method).

The backend is "gloo" for CPU tensors and "nccl" for CUDA tensors; NCCL
takes one rank per device, so on one card a group has one rank.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import queue as queue_mod
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("gloo", "nccl")
TIMEOUT = 120.0            # seconds a rank waits in a collective, and spawn for all ranks


@contextlib.contextmanager
def process_group(backend: str, rank: int, world: int, store_dir: str,
                  timeout: float = TIMEOUT):
    """This process as rank ``rank`` of ``world``, rendezvous through the
    file ``store`` in ``store_dir`` (empty before the first rank starts);
    the group is destroyed on exit. A collective that waits longer than
    ``timeout`` seconds raises."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method="file://" + os.path.join(store_dir, "store"),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        yield
    finally:
        dist.destroy_process_group()


def _numpy_tree(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, dict):
        return {k: _numpy_tree(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_numpy_tree(x) for x in v)
    return v


def _rank_main(fn, rank, world, backend, store_dir, timeout, results, args):
    torch.set_num_threads(1)
    try:
        with process_group(backend, rank, world, store_dir, timeout):
            out = _numpy_tree(fn(rank, world, *args))
        results.put((rank, None, out))
    except Exception:  # the parent reports it with this rank's traceback
        import traceback
        results.put((rank, traceback.format_exc(), None))


def _more_errors(results, wait: float = 2.0) -> list:
    """(rank, traceback) of the other ranks that fail within ``wait``
    seconds: a rank's own error can reach the queue after the error its
    exit caused in another rank."""
    errors = []
    deadline = time.monotonic() + wait
    while True:
        try:
            rank, err, _ = results.get(timeout=max(deadline - time.monotonic(), 0.01))
        except queue_mod.Empty:
            return errors
        if err is not None:
            errors.append((rank, err))


def spawn(fn, world: int, backend: str = "gloo", *args, timeout: float = TIMEOUT) -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` new ranks and return
    their results in rank order (tensors as numpy arrays, in dicts, lists
    and tuples too). A rank that raises, or a run longer than ``timeout``
    seconds, ends every rank and raises RuntimeError / TimeoutError."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out = [None] * world
    with tempfile.TemporaryDirectory() as store_dir:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, backend, store_dir, timeout, results, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        done = False
        try:
            for _ in range(world):
                try:
                    rank, err, value = results.get(timeout=max(deadline - time.monotonic(), 0.1))
                except queue_mod.Empty:
                    raise TimeoutError(f"{world} ranks of {fn.__name__} ran past {timeout} s")
                if err is not None:
                    raise RuntimeError(f"{fn.__name__} failed:\n" + "\n".join(
                        f"rank {r}: {e}" for r, e in [(rank, err)] + _more_errors(results)))
                out[rank] = value
            done = True
        finally:
            for p in procs:
                if not done:
                    p.kill()
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
    return out

