"""init_distributed maps the fluid trainer environment contract
(PADDLE_TRAINER_ID / PADDLE_TRAINERS / PADDLE_TRAINER_ENDPOINTS /
PADDLE_PSERVER_ENDPOINTS) to ``torch.distributed.init_process_group``,
explicit arguments winning — the cases of tests/test_init_distributed.py
with the process-group start intercepted."""
import pytest
import torch.distributed as dist

import paddle_tpu_torch as fluid
from paddle_tpu_torch.parallel import mesh as mesh_mod


class _Capture:
    def __init__(self):
        self.backend = None
        self.kwargs = None

    def __call__(self, backend=None, **kwargs):
        self.backend, self.kwargs = backend, kwargs


@pytest.fixture
def cap(monkeypatch):
    c = _Capture()
    monkeypatch.setattr(dist, "init_process_group", c)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    monkeypatch.delenv("PADDLE_TPU_CPU_COLLECTIVES", raising=False)
    monkeypatch.setattr(fluid.core.executor, "_FORCED_CPU", True)
    return c


def test_env_var_fallback(cap, monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS",
                       "10.0.0.1:7164,10.0.0.2:7164")
    monkeypatch.setenv("PADDLE_TRAINERS", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.delenv("PADDLE_PSERVER_ENDPOINTS", raising=False)
    assert mesh_mod.init_distributed() == 2
    assert cap.kwargs == {"init_method": "tcp://10.0.0.1:7164",
                          "world_size": 2, "rank": 1}
    assert cap.backend == "gloo"        # the host (force_cpu) reduces on gloo


def test_pserver_endpoints_win(cap, monkeypatch):
    monkeypatch.setenv("PADDLE_PSERVER_ENDPOINTS", "ps0:6174,ps1:6174")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS", "t0:7164")
    monkeypatch.setenv("PADDLE_TRAINERS", "4")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    mesh_mod.init_distributed()
    assert cap.kwargs["init_method"] == "tcp://ps0:6174"
    assert cap.kwargs["world_size"] == 4 and cap.kwargs["rank"] == 3


def test_explicit_args_override_env(cap, monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINERS", "8")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "7")
    mesh_mod.init_distributed(coordinator_address="host0:1234",
                              num_processes=2, process_id=0,
                              backend="nccl")
    assert cap.kwargs == {"init_method": "tcp://host0:1234",
                          "world_size": 2, "rank": 0}
    assert cap.backend == "nccl"


def test_mesh_spans_all_processes_after_init(cap, monkeypatch):
    """With no environment, init_process_group reads torchrun's own
    variables; the backend follows PADDLE_TPU_CPU_COLLECTIVES."""
    for v in ("PADDLE_PSERVER_ENDPOINTS", "PADDLE_TRAINER_ENDPOINTS",
              "PADDLE_TRAINERS", "PADDLE_TRAINER_ID"):
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setenv("PADDLE_TPU_CPU_COLLECTIVES", "gloo")
    mesh_mod.init_distributed(local_device_ids=[0])
    assert cap.kwargs == {} and cap.backend == "gloo"
    assert mesh_mod._backend_for("cuda") == "gloo"
    monkeypatch.delenv("PADDLE_TPU_CPU_COLLECTIVES")
    assert mesh_mod._backend_for("cuda") == "nccl"
    assert mesh_mod._backend_for("cpu") == "gloo"
