"""Inference wrapper (port of ``paddle_tpu/inferencer.py``; reference
python/paddle/fluid/inferencer.py).

``infer_func`` builds the forward-only graph and returns the output
variable(s); parameters are loaded from ``param_path`` (as written by
``Trainer.save_params`` / ``io.save_persistables``). The program is
cloned for test; it runs on the card unless ``place`` is ``CPUPlace()``.

Beyond the reference: an Inferencer is also loadable directly from a
``save_inference_model`` directory (:meth:`Inferencer.from_inference_model`
— no ``infer_func`` needed, the pruned program ships in the artifact),
and :meth:`Inferencer.serve` wraps it in a
:class:`~paddle_tpu_torch.serving.ServingEngine` for batched concurrent
traffic, :meth:`Inferencer.serve_decode` in a continuous-batching
:class:`~paddle_tpu_torch.serving.DecodeEngine`. ``serve(replicas >
1)``, ``serve(remotes=...)`` and ``serve_decode(replicas > 1)``
(replica pools behind a Router, remote hosts) are ROADMAP.md item
'Fleet and analyzers': they raise NotImplementedError naming it.
"""
import os

from . import io as fluid_io
from .core import framework
from .core.executor import Executor, Scope, default_place, scope_guard

__all__ = ["Inferencer"]


class Inferencer:
    def __init__(self, infer_func, param_path, place=None, parallel=False):
        self._place = place if place is not None else default_place()
        self.scope = Scope()
        self.startup_program = framework.Program()
        self.inference_program = framework.Program()
        self.feed_names = None      # fixed by from_inference_model only
        self.serving_manifest = {}  # populated by from_inference_model
        self.artifact_dir = None    # embedded compiled-artifact store
        with framework.program_guard(self.inference_program,
                                     self.startup_program), \
                framework.unique_name.guard():
            out = infer_func()
            self.fetch_vars = list(out) if isinstance(out, (list, tuple)) \
                else [out]
        self.inference_program = self.inference_program.clone(for_test=True)

        self.exe = Executor(self._place)
        with scope_guard(self.scope):
            self.exe.run(self.startup_program)
            fluid_io.load_persistables(
                self.exe, param_path, main_program=self.inference_program)

    @classmethod
    def from_inference_model(cls, dirname, place=None):
        """Build an Inferencer from a ``save_inference_model``
        directory — the deployment-side load path: the pruned program,
        feed/fetch contract, and parameters all come from the
        artifact, so the serving process needs no model-building code
        at all. Parameters land in this Inferencer's PRIVATE scope."""
        self = cls.__new__(cls)
        self._place = place if place is not None else default_place()
        self.scope = Scope()
        self.startup_program = None
        self.exe = Executor(self._place)
        program, feed_names, fetch_vars = fluid_io.load_inference_model(
            dirname, self.exe, scope=self.scope)
        self.inference_program = program
        self.feed_names = list(feed_names)
        self.fetch_vars = fetch_vars
        # serving geometry the exporter persisted (bucket manifest,
        # decode max_batch) — serve() warms exactly these buckets
        self.serving_manifest = fluid_io.load_serving_manifest(dirname)
        # artifact store embedded at export time
        # (save_inference_model(artifact_store=True)) — serve(
        # compile_store=True) hands it to the engine it builds, so its
        # warmup loads the exporter's steps instead of building them
        from .io.artifact_store import EMBEDDED_DIRNAME
        embedded = os.path.join(dirname, EMBEDDED_DIRNAME)
        self.artifact_dir = embedded if os.path.isdir(embedded) else None
        return self

    # the saved-model loader under the name the serving docs use; the
    # fluid-parity name stays primary
    from_saved_model = from_inference_model

    def infer(self, inputs, return_numpy=True):
        """``inputs`` is a dict {data_var_name: ndarray}."""
        if not isinstance(inputs, dict):
            raise TypeError("inputs must be a dict of name -> array")
        with scope_guard(self.scope):
            return self.exe.run(self.inference_program, feed=inputs,
                                fetch_list=self.fetch_vars,
                                return_numpy=return_numpy)

    def serve(self, buckets=None, config=None, auto_start=True,
              warmup=False, replicas=1, policy="health_aware",
              max_cluster_queue=None, compile_store=None,
              remotes=None, net_token=None):
        """Wrap this model in a :class:`~paddle_tpu_torch.serving.
        ServingEngine` (batched concurrent inference over shape
        buckets, plus the hardening layer: health states, watchdog,
        circuit breakers, graceful drain). The engine shares this
        Inferencer's scope and place. ``warmup=True`` runs every
        declared bucket before returning, so the engine comes back
        traffic-ready with the no-rebuild contract armed. Feed names
        default to the artifact's contract (from_inference_model) or
        the program's data variables. ``buckets`` defaults to the
        bucket manifest the exporter persisted, when the artifact has
        one. ``compile_store=True`` serves from the saved model's
        embedded ``__artifacts__`` store (``artifact_dir``; ValueError
        when none was exported); the default (None) is
        ``PADDLE_TPU_ARTIFACT_DIR``, else no store.

        ``replicas > 1`` and ``remotes=`` (a balanced Router over a
        replica pool or over remote hosts) raise NotImplementedError:
        they are ROADMAP.md item 'Fleet and analyzers'."""
        if remotes:
            raise NotImplementedError(
                "serve(remotes=...) routes to remote replica hosts, a "
                "later slice of the torch port (ROADMAP.md item 'Fleet "
                "and analyzers')")
        if int(replicas) > 1:
            raise NotImplementedError(
                f"serve(replicas={replicas}) builds a replica pool behind "
                "a Router, a later slice of the torch port (ROADMAP.md "
                "item 'Fleet and analyzers')")
        from .serving import BucketSpec, ServingEngine
        feed_names = self.feed_names
        if feed_names is None:
            gb = self.inference_program.global_block()
            feed_names = [n for n, v in sorted(gb.vars.items())
                          if getattr(v, "is_data", False)]
        manifest = getattr(self, "serving_manifest", None) or {}
        if buckets is None and manifest.get("buckets"):
            buckets = BucketSpec.from_manifest(manifest["buckets"])
        if compile_store is True:
            compile_store = getattr(self, "artifact_dir", None)
            if compile_store is None:
                raise ValueError(
                    "serve(compile_store=True) needs an Inferencer loaded "
                    "from a saved model with an embedded artifact store "
                    "(save_inference_model(..., artifact_store=True))")
        eng = ServingEngine(self.inference_program, feed_names,
                            self.fetch_vars, scope=self.scope,
                            place=self._place, buckets=buckets,
                            config=config, auto_start=auto_start,
                            compile_store=compile_store)
        if warmup:
            eng.warmup()
        return eng

    def serve_decode(self, cfg, config=None, draft_cfg=None,
                     auto_start=True, warmup=False, replicas=1,
                     policy="health_aware", max_cluster_queue=None,
                     compile_store=None):
        """Wrap this Inferencer's scope in a continuous-batching
        :class:`~paddle_tpu_torch.serving.DecodeEngine` on this
        Inferencer's place (the card by default). The scope must hold
        the generator-layout weights for ``cfg`` (a ``param_path``
        written from a stacked or quantized serving scope, with draft
        weights under ``draft.*`` when ``draft_cfg`` is given); the
        decode engine never initializes weights. ``warmup=True`` builds
        every step, so the engine comes back with the no-recompile
        contract armed. ``compile_store`` hands the engine a persistent
        artifact store (None defers to PADDLE_TPU_ARTIFACT_DIR).
        ``replicas > 1`` (a Router over decode engines sharing this
        scope) is ROADMAP.md item 'Fleet and analyzers' and raises
        NotImplementedError naming it; ``policy`` and
        ``max_cluster_queue`` belong to that Router."""
        if int(replicas) > 1:
            raise NotImplementedError(
                f"serve_decode(replicas={replicas}) builds a replica pool "
                "behind a Router, a later slice of the torch port "
                "(ROADMAP.md item 'Fleet and analyzers')")
        from .serving import DecodeEngine
        eng = DecodeEngine(cfg, scope=self.scope, place=self._place,
                           config=config, draft_cfg=draft_cfg,
                           auto_start=auto_start,
                           compile_store=compile_store)
        if warmup:
            eng.warmup()
        return eng
