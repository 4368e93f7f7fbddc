"""The bucketed serving engine of the torch port against the JAX package
on the CPU (paddle_tpu_torch/serving/: buckets.py, batching.py,
engine.py): every case of ``tests/test_serving.py`` runs the same
input, clock and fault schedule through both packages
(``tests/torch_serving_common.py`` ``both``), holds each package to the
reference test's own assertions, and holds the port's outcome to the
reference's — answers at ANSWER_TOL (rtol 1e-6 / atol 1e-7, the
reference's served-against-direct tolerance), counters, shapes and
error types exactly. Within each package, batched answers equal the
request served alone in the same bucket bit for bit; alone in a smaller
bucket, within ANSWER_TOL (ROADMAP §3 F22).

Reference test → port case:

- ``test_bucket_selection_and_errors`` → ``test_bucket_selection_and_errors``
- ``test_signature_groups_by_padded_length`` → ``test_signature_groups_by_padded_length``
- ``test_pad_batch_round_trip`` → ``test_pad_batch_round_trip``
- ``test_all_signatures_is_the_warmup_set`` → ``test_all_signatures_is_the_warmup_set``
- ``test_batcher_flushes_full_batch_immediately``,
  ``test_batcher_deadline_flushes_partial_batch``,
  ``test_batcher_groups_by_signature``,
  ``test_batcher_sweeps_expired_before_serving``,
  ``test_batcher_sheds_at_capacity`` → ``test_micro_batcher_under_a_fake_clock``
  [flush, deadline, groups, sweep, shed]
- ``test_batched_results_bit_exact_vs_single_request`` → ``test_batched_results_bit_exact_vs_single_request``
- ``test_deadline_flush_serves_partial_batch`` → ``test_deadline_flush_serves_partial_batch``
- ``test_queue_full_sheds_with_metrics`` → ``test_queue_full_sheds_with_metrics``
- ``test_per_request_timeout_structured_error`` → ``test_per_request_timeout_structured_error``
- ``test_warmup_compiles_each_bucket_exactly_once`` → ``test_warmup_compiles_each_bucket_exactly_once``
  (it found ROADMAP §3 F21: the port's Executor had no ``compile_cache_keys``)
- ``test_seq_bucket_padding_end_to_end`` → ``test_seq_bucket_padding_end_to_end``
- ``test_metrics_snapshot_sanity`` → ``test_metrics_snapshot_sanity``
- ``test_worker_retries_transient_device_errors`` → ``test_worker_retries_transient_device_errors``
- ``test_worker_survives_request_errors`` → ``test_worker_survives_request_errors``
- ``test_serving_from_saved_model_and_inferencer`` → ``test_serving_from_saved_model_and_inferencer``

Waits are bounded (``infer(timeout=…)``, ``result(timeout=…)``); the
only sleep lets a request's deadline pass while the worker is down, as
in the reference.
"""
import json
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch import weights

from torch_serving_common import (ANSWER_TOL, CPU, PKGS, FakeClock,
                                  assert_answers_close, both, counters,
                                  disarm_all, engine, model_pair,
                                  scope_arrays, to_numpy)

torch.set_num_threads(1)

pytestmark = pytest.mark.serving


@pytest.fixture(autouse=True)
def _clean_faults():
    disarm_all()
    yield
    disarm_all()


# ---------------------------------------------------------------------------
# buckets.py — pure policy and padding
# ---------------------------------------------------------------------------

def test_bucket_selection_and_errors():
    def case(p):
        spec = p.serving.BucketSpec(batch_sizes=(1, 2, 4, 8),
                                    seq_lens={"tok": (8, 16)})
        got = [spec.batch_bucket(n) for n in (1, 3, 8)]
        got += [spec.seq_bucket("tok", n) for n in (5, 16)]
        got.append(spec.seq_bucket("img", 999))
        assert got == [1, 4, 8, 8, 16, 999]
        errors = []
        for call in (lambda: spec.batch_bucket(9),
                     lambda: spec.seq_bucket("tok", 17),
                     lambda: p.serving.BucketSpec(batch_sizes=()),
                     lambda: p.serving.BucketSpec(batch_sizes=(0, 2))):
            with pytest.raises((p.serving.BucketError, ValueError)) as e:
                call()
            errors.append(type(e.value).__name__)
        assert errors == ["BucketError", "BucketError", "ValueError",
                          "ValueError"]
        return got, errors

    out = both(case)
    assert out["port"] == out["jax"]


def test_signature_groups_by_padded_length():
    def case(p):
        spec = p.serving.BucketSpec(batch_sizes=(1, 4),
                                    seq_lens={"tok": (8, 16)})
        sigs = [spec.signature({"tok": np.zeros((1, n), np.int64)})
                for n in (5, 7, 12)]
        assert sigs[0] == sigs[1] == (("tok", 8),)
        assert sigs[2] == (("tok", 16),)
        plain = p.serving.BucketSpec(batch_sizes=(1,)).signature(
            {"img": np.zeros((1, 3, 4, 4))})
        assert plain == ()
        return sigs, plain

    out = both(case)
    assert out["port"] == out["jax"]


def test_pad_batch_round_trip():
    def case(p):
        BucketSpec = p.serving.BucketSpec
        spec = BucketSpec(batch_sizes=(1, 2, 4, 8),
                          seq_lens={"tok": (8,)}, pad_values={"tok": 7})
        feeds = [{"tok": np.arange(5, dtype=np.int64).reshape(1, 5)},
                 {"tok": np.arange(6, dtype=np.int64).reshape(2, 3)}]
        batch, n_rows, bucket_rows = spec.pad_batch(feeds)
        assert n_rows == 3 and bucket_rows == 4
        assert batch["tok"].shape == (4, 8)
        assert (batch["tok"][0, 5:] == 7).all()
        np.testing.assert_array_equal(batch["tok"][3], batch["tok"][0])
        outs = BucketSpec.unpad_rows([batch["tok"]], [1, 2])
        assert outs[0][0].shape == (1, 8) and outs[1][0].shape == (2, 8)
        np.testing.assert_array_equal(outs[1][0], batch["tok"][1:3])
        scalars = BucketSpec.unpad_rows([np.float32(3.5)], [1, 2])
        assert scalars[0][0] == scalars[1][0] == np.float32(3.5)
        return batch["tok"], [o[0] for o in outs], float(scalars[1][0])

    out = both(case)
    (jb, jo, js), (tb, to, ts) = out["jax"], out["port"]
    np.testing.assert_array_equal(tb, jb)
    assert all(np.array_equal(a, b) for a, b in zip(to, jo))
    assert ts == js


def test_all_signatures_is_the_warmup_set():
    def case(p):
        spec = p.serving.BucketSpec(batch_sizes=(2, 4),
                                    seq_lens={"tok": (8, 16)})
        sigs = spec.all_signatures()
        assert len(sigs) == 4
        assert (2, (("tok", 8),)) in sigs and (4, (("tok", 16),)) in sigs
        fed = spec.all_signatures(names={"img"})
        assert fed == [(2, ()), (4, ())]
        return sigs, fed

    out = both(case)
    assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# batching.py — deterministic queueing under a fake clock
# ---------------------------------------------------------------------------

def _req(p, n_rows=1, sig=(), deadline=None, clock=None):
    t = clock.t if clock else 0.0
    return p.serving.PendingResult(feed={}, n_rows=n_rows, signature=sig,
                                   deadline=deadline, enqueued_at=t)


def _flush(p):
    clk = FakeClock()
    mb = p.serving.MicroBatcher(max_batch_size=4, max_wait_s=10.0,
                                max_queue=16, clock=clk)
    reqs = [_req(p, 2, clock=clk), _req(p, 2, clock=clk),
            _req(p, 1, clock=clk)]
    for r in reqs:
        mb.put(r)
    batch, expired = mb.next_batch()
    assert batch == reqs[:2] and not expired   # 4 rows = full, no wait
    assert mb.depth() == 1
    return [[reqs.index(r) for r in batch], len(expired), mb.depth()]


def _deadline(p):
    clk = FakeClock()
    mb = p.serving.MicroBatcher(max_batch_size=8, max_wait_s=0.5,
                                max_queue=16, clock=clk)
    r = _req(p, 3, clock=clk)
    mb.put(r)
    clk.t += 0.6          # the oldest member's window has expired
    batch, expired = mb.next_batch()
    assert batch == [r] and not expired
    return [len(batch), len(expired), mb.depth()]


def _groups(p):
    clk = FakeClock()
    mb = p.serving.MicroBatcher(max_batch_size=4, max_wait_s=0.0,
                                max_queue=16, clock=clk)
    reqs = [_req(p, 2, sig="A", clock=clk), _req(p, 2, sig="B", clock=clk),
            _req(p, 2, sig="A", clock=clk)]
    for r in reqs:
        mb.put(r)
    first, _ = mb.next_batch()
    second, _ = mb.next_batch()
    assert first == [reqs[0], reqs[2]] and second == [reqs[1]]
    return [[reqs.index(r) for r in first], [reqs.index(r) for r in second]]


def _sweep(p):
    clk = FakeClock()
    mb = p.serving.MicroBatcher(max_batch_size=4, max_wait_s=0.0,
                                max_queue=16, clock=clk)
    dead = _req(p, 1, deadline=clk.t - 1.0, clock=clk)
    live = _req(p, 1, clock=clk)
    mb.put(dead)
    mb.put(live)
    b1, e1 = mb.next_batch()
    assert e1 == [dead] and b1 == []           # the sweep reports first
    b2, e2 = mb.next_batch()
    assert b2 == [live] and not e2
    return [len(b1), len(e1), len(b2), len(e2)]


def _shed(p):
    mb = p.serving.MicroBatcher(max_batch_size=4, max_wait_s=0.0,
                                max_queue=2)
    mb.put(_req(p))
    mb.put(_req(p))
    with pytest.raises(p.serving.QueueFullError):
        mb.put(_req(p))
    return [mb.depth()]


@pytest.mark.parametrize("case", [_flush, _deadline, _groups, _sweep,
                                  _shed],
                         ids=["flush", "deadline", "groups", "sweep",
                              "shed"])
def test_micro_batcher_under_a_fake_clock(case):
    out = both(case)
    assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# engine.py — end to end on a real program
# ---------------------------------------------------------------------------

def test_batched_results_bit_exact_vs_single_request():
    """Concurrent coalesced requests return, row for row, exactly what
    each request gets when served alone in the same bucket, in each
    package; served alone in its own smaller bucket, within ANSWER_TOL
    (ROADMAP §3 F22: torch's CPU and CUDA GEMMs pick their reduction
    order by shape, so a row's last bits follow its bucket, never its
    batch-mates; the reference's XLA CPU GEMM does the same on some
    hosts). The port's answers equal the reference's within
    ANSWER_TOL."""
    models = model_pair()
    rng = np.random.RandomState(0)
    feeds = [{"x": rng.randn(n, 8).astype(np.float32)}
             for n in (1, 2, 1, 3)]           # 7 rows -> one 8-bucket

    def case(p):
        with engine(p, models[p.name], config=p.serving.ServingConfig(
                max_wait_ms=200.0)) as eng:
            eng.warmup()
            # 7 rows never fill the 8-bucket: the batcher holds all four
            # until the window closes — exactly one coalesced batch
            pending = [eng.submit(f, timeout=30.0) for f in feeds]
            results = [p_.result(timeout=30.0) for p_ in pending]
            stats = eng.stats()
            eng.assert_no_recompiles()
            singles = [eng.infer(f, timeout=30.0) for f in feeds]
        with engine(p, models[p.name],
                    buckets=p.serving.BucketSpec(batch_sizes=(8,))) as eng:
            same_bucket = [eng.infer(f, timeout=30.0) for f in feeds]
        for got, alone, in8, feed in zip(results, singles, same_bucket,
                                         feeds):
            assert got[0].shape == (feed["x"].shape[0], 10)
            np.testing.assert_array_equal(to_numpy(got[0]),
                                          to_numpy(in8[0]))
            np.testing.assert_allclose(to_numpy(got[0]), to_numpy(alone[0]),
                                       **ANSWER_TOL)
        assert stats["responses_total"] == len(feeds)
        assert stats["batches_total"] == 1        # all four coalesced
        assert stats["rows_total"] == 7 and stats["padded_rows_total"] == 8
        return results, counters(stats, ("responses_total", "batches_total",
                                         "rows_total", "padded_rows_total"))

    out = both(case)
    assert out["port"][1] == out["jax"][1]
    assert_answers_close(out["port"][0], out["jax"][0])


def test_deadline_flush_serves_partial_batch():
    models = model_pair()

    def case(p):
        with engine(p, models[p.name], config=p.serving.ServingConfig(
                max_wait_ms=5.0)) as eng:
            eng.warmup()
            t0 = time.monotonic()
            out = eng.infer({"x": np.zeros((3, 8), np.float32)},
                            timeout=30.0)
            elapsed = time.monotonic() - t0
            stats = eng.stats()
        assert out[0].shape == (3, 10)
        assert stats["rows_total"] == 3 and stats["padded_rows_total"] == 4
        assert elapsed < 10.0, "deadline flush never happened"
        return [out], counters(stats, ("rows_total", "padded_rows_total",
                                       "batches_total"))

    out = both(case)
    assert out["port"][1] == out["jax"][1]
    assert_answers_close(out["port"][0], out["jax"][0])


def test_queue_full_sheds_with_metrics():
    models = model_pair()

    def case(p):
        eng = engine(p, models[p.name], auto_start=False,
                     config=p.serving.ServingConfig(max_wait_ms=1.0,
                                                    max_queue=2))
        try:
            feed = {"x": np.zeros((1, 8), np.float32)}
            eng.submit(feed)
            eng.submit(feed)
            with pytest.raises(p.serving.QueueFullError):
                eng.submit(feed)
            with pytest.raises(p.serving.BucketError):
                eng.submit({"x": np.zeros((9, 8), np.float32)})
            stats = eng.stats()
        finally:
            eng.close()
        assert stats["shed_total"] == 2
        assert stats["requests_total"] == 2      # rejected != admitted
        assert stats["queue_depth"] == 2
        return counters(stats, ("shed_total", "requests_total",
                                "queue_depth", "responses_total"))

    out = both(case)
    assert out["port"] == out["jax"]


def test_per_request_timeout_structured_error():
    models = model_pair()

    def case(p):
        eng = engine(p, models[p.name], auto_start=False)
        try:
            req = eng.submit({"x": np.zeros((1, 8), np.float32)},
                             timeout=0.01)
            time.sleep(0.05)      # the deadline passes while no worker runs
            eng.start()
            with pytest.raises(p.serving.RequestTimeoutError):
                req.result(timeout=10.0)
            deadline = time.monotonic() + 5.0
            while eng.stats()["timeouts_total"] < 1 \
                    and time.monotonic() < deadline:
                time.sleep(0.005)
            stats = eng.stats()
        finally:
            eng.close()
        assert stats["timeouts_total"] == 1
        return counters(stats, ("timeouts_total", "responses_total",
                                "errors_total"))

    out = both(case)
    assert out["port"] == out["jax"]


def test_warmup_compiles_each_bucket_exactly_once():
    """Warmup builds one step per declared bucket, and steady traffic of
    every in-bucket size builds none: one lowered program, three shape
    specializations, in both packages."""
    models = model_pair()
    rng = np.random.RandomState(1)
    feeds = [{"x": rng.randn(n, 8).astype(np.float32)}
             for n in (1, 2, 3, 4, 1, 3, 2, 4)]

    def case(p):
        buckets = p.serving.BucketSpec(batch_sizes=(1, 2, 4))
        with engine(p, models[p.name], buckets=buckets) as eng:
            report = eng.warmup()
            assert report == {"signatures": 3, "compiles": 3}
            assert eng.exe.total_compiles() == 3
            keys = eng.exe.compile_cache_keys()
            assert len(keys) == 1
            assert eng.exe.compile_counts()[keys[0]] == 3
            outs = []
            for f in feeds:
                out = eng.infer(f, timeout=30.0)
                assert out[0].shape == (f["x"].shape[0], 10)
                outs.append(out)
            eng.assert_no_recompiles()
            assert eng.exe.total_compiles() == 3
            stats = eng.stats()
        return (report, len(keys), outs,
                counters(stats, ("warmup_compiles", "compiles_now",
                                 "responses_total")))

    out = both(case)
    (jr, jk, jo, jc), (tr, tk, to, tc) = out["jax"], out["port"]
    assert (tr, tk, tc) == (jr, jk, jc)
    assert tc["warmup_compiles"] == 3
    assert_answers_close(to, jo)


def _seq_model(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        tok = fluid.layers.data(name="tok", shape=[-1, -1], dtype="int64",
                                append_batch_size=False)
        emb = fluid.layers.embedding(tok, size=[16, 8])
        pooled = fluid.layers.reduce_mean(emb, dim=1)
        pred = fluid.layers.fc(pooled, size=4, act="softmax")
    return main, startup, pred


def test_seq_bucket_padding_end_to_end():
    """Length-bucketed token input: requests of different raw lengths
    run through the (batch, len) buckets warmed once, and an oversize
    length is refused before queueing."""
    models = model_pair(_seq_model)
    rng = np.random.RandomState(2)
    feeds = [{"tok": rng.randint(0, 16, (1, n)).astype(np.int64)}
             for n in (3, 4, 6, 8)]

    def case(p):
        buckets = p.serving.BucketSpec(batch_sizes=(1, 2),
                                       seq_lens={"tok": (4, 8)})
        with engine(p, models[p.name], feed_names=("tok",),
                    buckets=buckets,
                    config=p.serving.ServingConfig(max_wait_ms=5.0)) as eng:
            report = eng.warmup()
            assert report["signatures"] == 4
            outs = [eng.infer(f, timeout=30.0) for f in feeds]
            for o in outs:
                assert o[0].shape == (1, 4)
            eng.assert_no_recompiles()
            with pytest.raises(p.serving.BucketError):
                eng.submit({"tok": np.zeros((1, 9), np.int64)})
        return report, outs

    out = both(case)
    assert out["port"][0] == out["jax"][0]
    assert_answers_close(out["port"][1], out["jax"][1])


def test_metrics_snapshot_sanity():
    models = model_pair()
    names = ("requests_total", "responses_total", "errors_total",
             "shed_total", "timeouts_total", "rows_total", "compiles_now",
             "warmup_compiles")

    def case(p):
        with engine(p, models[p.name]) as eng:
            eng.warmup()
            for n in (1, 2, 4):
                eng.infer({"x": np.zeros((n, 8), np.float32)}, timeout=30.0)
            stats = eng.stats()
        assert stats["requests_total"] == stats["responses_total"] == 3
        assert stats["errors_total"] == stats["shed_total"] == 0
        assert stats["timeouts_total"] == 0
        assert stats["batches_total"] >= 1
        assert stats["rows_total"] == 7
        assert stats["padded_rows_total"] >= stats["rows_total"]
        assert 0 < stats["batch_fill_ratio"] <= 1.0
        lat = stats["request_latency"]
        assert lat["p50_ms"] is not None
        assert lat["p50_ms"] <= lat["p95_ms"] <= lat["p99_ms"]
        assert stats["compiles_now"] == stats["warmup_compiles"] == 4
        json.dumps(stats)              # the snapshot is plain JSON
        return counters(stats, names), sorted(stats)

    out = both(case)
    assert out["port"][0] == out["jax"][0]
    # the port's snapshot carries every key of the reference's
    assert set(out["jax"][1]) <= set(out["port"][1])


def test_worker_retries_transient_device_errors():
    """An injected transient device error on the batch dispatch (the
    executor's own ``device_error`` point, below a retry-free inner
    executor) is retried at the serving layer on the policy's schedule,
    counted in retries_total, and the request succeeds."""
    models = model_pair()

    def case(p):
        sleeps = []
        policy = p.retry.RetryPolicy(max_attempts=3, initial_backoff=0.01,
                                     sleep=sleeps.append)
        with engine(p, models[p.name], config=p.serving.ServingConfig(
                max_wait_ms=1.0, retry_policy=policy)) as eng:
            eng.warmup()
            p.faultinject.arm("device_error", at=0, times=1)
            try:
                out = eng.infer({"x": np.ones((1, 8), np.float32)},
                                timeout=30.0)
            finally:
                p.faultinject.disarm()
            stats = eng.stats()
        assert out[0].shape == (1, 10)
        assert stats["retries_total"] == 1
        assert stats["errors_total"] == 0
        assert stats["responses_total"] == 1
        assert sleeps == [0.01]
        return [out], sleeps, counters(stats, ("retries_total",
                                               "errors_total",
                                               "responses_total"))

    out = both(case)
    assert out["port"][1:] == out["jax"][1:]
    assert_answers_close(out["port"][0], out["jax"][0])


def test_worker_survives_request_errors():
    """A bad batch fails its requests with the real exception, and the
    worker keeps serving later traffic."""
    models = model_pair()

    def case(p):
        with engine(p, models[p.name]) as eng:
            eng.warmup()
            with pytest.raises(Exception):
                # wrong trailing dim: the step fails inside run
                eng.infer({"x": np.zeros((1, 5), np.float32)},
                          timeout=30.0)
            out = eng.infer({"x": np.zeros((1, 8), np.float32)},
                            timeout=30.0)
            stats = eng.stats()
        assert out[0].shape == (1, 10)
        assert stats["errors_total"] == 1
        assert stats["responses_total"] == 1
        return [out], counters(stats, ("errors_total", "responses_total",
                                       "requests_total"))

    out = both(case)
    assert out["port"][1] == out["jax"][1]
    assert_answers_close(out["port"][0], out["jax"][0])


def _linear(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        pred = fluid.layers.fc(x, size=10, act="softmax")
    return main, startup, pred


def test_serving_from_saved_model_and_inferencer(tmp_path):
    """save_inference_model → ServingEngine.from_saved_model serves what
    a direct run gives; Inferencer.from_inference_model and its serve()
    agree. Both packages save the same weights; the port's answers equal
    the reference's within ANSWER_TOL."""
    jmain, jstartup, _ = _linear(PKGS["jax"].fluid)
    jscope = PKGS["jax"].fluid.Scope()
    PKGS["jax"].fluid.Executor(PKGS["jax"].fluid.CPUPlace()).run(
        jstartup, scope=jscope)
    arrays = scope_arrays(jscope)
    x = np.ones((2, 8), np.float32)

    def case(p):
        fluid = p.fluid
        main, _, pred = _linear(fluid)
        if p.name == "jax":
            scope = jscope
        else:
            scope = weights.load_state(fluid.Scope(), arrays, CPU)
        exe = fluid.Executor(fluid.CPUPlace())
        d = str(tmp_path / p.name)
        with fluid.scope_guard(scope):
            fluid.io.save_inference_model(d, ["x"], [pred], exe,
                                          main_program=main)
            ref = to_numpy(exe.run(main.clone(for_test=True), feed={"x": x},
                                   fetch_list=[pred], mode="test")[0])
        BucketSpec, ServingConfig = (p.serving.BucketSpec,
                                     p.serving.ServingConfig)
        with p.serving.ServingEngine.from_saved_model(
                d, place=fluid.CPUPlace(),
                buckets=BucketSpec(batch_sizes=(1, 2)),
                config=ServingConfig(max_wait_ms=5.0)) as eng:
            eng.warmup()
            out = eng.infer({"x": x}, timeout=30.0)
        np.testing.assert_allclose(to_numpy(out[0]), ref, rtol=1e-6)
        inf = fluid.Inferencer.from_inference_model(d,
                                                    place=fluid.CPUPlace())
        assert inf.feed_names == ["x"]
        direct = to_numpy(inf.infer({"x": x})[0])
        np.testing.assert_allclose(direct, ref, rtol=1e-6)
        with inf.serve(buckets=BucketSpec(batch_sizes=(1, 2)),
                       config=ServingConfig(max_wait_ms=5.0)) as eng2:
            eng2.warmup()
            served = eng2.infer({"x": x}, timeout=30.0)
        np.testing.assert_array_equal(to_numpy(served[0]), direct)
        return [[ref], out, [direct], served]

    out = both(case)
    assert_answers_close(out["port"], out["jax"])
