"""Multi-rank harness of the port's mesh tests: gloo ranks on the host.

The test process (which has imported jax) never runs a rank itself: it
starts ``world`` fresh processes with the ``spawn`` method, each of
which imports only torch and the port (this module imports neither jax
nor paddle_tpu), joins a gloo group through a ``FileStore`` under the
test's ``tmp_path`` (no ports), runs one case function of a case
module and writes what it returns (rank 0's) to ``tmp_path``. A group
that outlives its timeout is killed and the test fails.
:func:`shared_ranks` runs a group once per test session: the
pytest-xdist workers share its result through a file beside their
temporary directories, the first worker running the group while the
others wait on a lock.
"""
import fcntl
import importlib
import multiprocessing
import os
import pickle
import sys
import time
import traceback

__all__ = ["run_ranks", "shared_ranks"]


def _entry(module, case, rank, world, tmp, args):
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        store = dist.FileStore(os.path.join(tmp, "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world)
        import paddle_tpu_torch as fluid
        fluid.force_cpu()
        fn = getattr(importlib.import_module(module), case)
        out = fn(rank, world, *args)
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "paddle_tpu"))
        if rank == 0:
            with open(os.path.join(tmp, "result.pkl"), "wb") as f:
                pickle.dump({"out": out, "jax_modules": loaded}, f)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(module, case, world, tmp_path, *args, timeout=120):
    """Run ``module.case(rank, world, *args)`` on ``world`` gloo ranks and
    return rank 0's result; raise with the first rank's traceback if a
    rank fails, and kill the group past ``timeout`` seconds."""
    tmp = str(tmp_path)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry,
                         args=(module, case, r, world, tmp, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
        for p in hung:
            p.join(5)
    errors = []
    for r in range(world):
        path = os.path.join(tmp, f"error{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    if errors:
        raise AssertionError("\n".join(errors))
    if hung:
        raise AssertionError(f"{module}.{case}: {len(hung)} of {world} "
                             f"ranks still running after {timeout} s")
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise AssertionError(f"{module}.{case}: rank exit codes {bad}")
    with open(os.path.join(tmp, "result.pkl"), "rb") as f:
        res = pickle.load(f)
    assert not res["jax_modules"], res["jax_modules"]
    return res["out"]


def shared_ranks(module, case, world, tmp_path_factory, timeout=120):
    """:func:`run_ranks` once per session across xdist workers: the
    result (or the failure) is kept in a file beside the workers'
    temporary directories, under a lock."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if base.name.startswith("popen-gw") else base
    key = os.path.join(str(root), f"ranks-{module}-{case}-{world}")
    with open(key + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(key + ".pkl"):
                with open(key + ".pkl", "rb") as f:
                    ok, out = pickle.load(f)
            else:
                try:
                    os.makedirs(key, exist_ok=True)
                    ok, out = True, run_ranks(module, case, world, key,
                                              timeout=timeout)
                except AssertionError as e:
                    ok, out = False, str(e)
                with open(key + ".pkl", "wb") as f:
                    pickle.dump((ok, out), f)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    if not ok:
        raise AssertionError(out)
    return out
