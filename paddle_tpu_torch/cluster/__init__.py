"""paddle_tpu_torch.cluster — multi-replica serving and the train
fabric (port of ``paddle_tpu/cluster/``): router, replica pool,
health-aware balancing, zero-downtime rolling restart, socket
replicas, canary deploys, and elastic data-parallel training over the
same wire.

A :class:`ReplicaPool` owns N identical engine replicas (in-process by
default, sharing one read-only parameter scope on the card;
:class:`ProcessReplica` drives the same interface over a separate OS
process), and a :class:`Router` spreads traffic across them with
pluggable balancing (round-robin, least-outstanding, and health-aware
weighting that reads each replica's HealthMonitor + circuit-breaker
state), cluster-level admission control, transparent failover, and
merged pool-wide metrics. The pool revives crashed replicas and rolls
restarts one replica at a time — zero lost requests under load
(``chip_smoke.py``'s ``cluster_serve`` phase on the card)::

    from paddle_tpu_torch import cluster, serving

    def factory():
        return serving.ServingEngine.from_saved_model("./model_dir")

    router = cluster.serve_cluster(factory, replicas=2, warmup=True)
    out = router.infer({"img": x})       # balanced, failover-protected
    router.pool.rolling_restart()        # zero-downtime deploy
    router.close(drain=True)

Across hosts, the same data plane rides the socket fabric
(``cluster/net.py`` CRC-framed transport, handshake auth, per-
connection circuit breakers, deadline-aware RPC, membership with
staleness eviction)::

    # on each serving host (the card; --cpu for the host):
    #   python -m paddle_tpu_torch.cluster.net_worker \
    #       --dir ./model_dir --port 7711
    router = cluster.serve_remotes(["10.0.0.5:7711", "10.0.0.6:7711"])
    out = router.infer({"img": x})       # identical client contract

On top of the pool, ``cluster/deploy.py`` closes the deployment loop
(*ship, observe, revert*): a :class:`DeploymentManager` names
immutable model versions, dark-deploys a canary behind router version
weights (``Router.set_weights``), gates promotion on a pinned
golden-set numerics check plus error-rate/p99 guardrails, and
auto-rolls-back with zero lost requests.
"""
from .deploy import (DeploymentError, DeploymentManager,         # noqa: F401
                     Guardrails, ModelVersion, check_numerics,
                     evaluate_guardrails)
from .membership import Membership, serve_remotes                # noqa: F401
from .net import (FrameError, HandshakeError,                    # noqa: F401
                  RemoteUnavailableError)
from .net_worker import ReplicaServer, provision_from_remote     # noqa: F401
from .pool import ReplicaPool                                    # noqa: F401
from .remote import RemoteReplica                                # noqa: F401
from .replica import InProcessReplica, ProcessReplica, Replica   # noqa: F401
from .router import (BalancePolicy, ClusterOverloadError,        # noqa: F401
                     HealthAwarePolicy, LeastOutstandingPolicy,
                     NoReadyReplicaError, POLICIES, RoundRobinPolicy,
                     Router, get_policy)
from .train_fabric import (CommitMismatch, LinRegTask,           # noqa: F401
                           NoTrainWorkersError, ProgramGradTask,
                           TrainCoordinator, TrainTaskError,
                           WorkerClient, task_from_spec)
from .train_worker import TrainWorkerServer                      # noqa: F401

__all__ = ["BalancePolicy", "ClusterOverloadError", "CommitMismatch",
           "DeploymentError",
           "DeploymentManager", "FrameError", "Guardrails",
           "HandshakeError", "HealthAwarePolicy", "InProcessReplica",
           "LeastOutstandingPolicy", "LinRegTask", "Membership",
           "ModelVersion",
           "NoReadyReplicaError", "NoTrainWorkersError", "POLICIES",
           "ProcessReplica", "ProgramGradTask",
           "RemoteReplica", "RemoteUnavailableError", "Replica",
           "ReplicaPool", "ReplicaServer", "RoundRobinPolicy",
           "Router", "TrainCoordinator", "TrainTaskError",
           "TrainWorkerServer", "WorkerClient", "check_numerics",
           "evaluate_guardrails",
           "get_policy", "provision_from_remote", "serve_cluster",
           "serve_remotes", "task_from_spec"]


def serve_cluster(factory, replicas=2, policy="health_aware",
                  warmup=False, max_cluster_queue=None,
                  revive_interval_s=0.25):
    """One call from engine factory to balanced, self-healing router:
    builds a :class:`ReplicaPool` of ``replicas`` engines and fronts
    it with a :class:`Router`. The router owns the pool (closing the
    router closes the pool)."""
    pool = ReplicaPool(factory, replicas=replicas, warmup=warmup,
                       revive_interval_s=revive_interval_s)
    return Router(pool, policy=policy,
                  max_cluster_queue=max_cluster_queue)
