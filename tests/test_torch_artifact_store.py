"""The persistent artifact store of the torch port
(paddle_tpu_torch/io/artifact_store.py) and its executor and serving
wiring — the semantics of tests/test_artifact_store.py, on the port's
payload: a test-mode step exported through ``torch.export`` for one
argument signature.

* content-addressed reuse — a second executor or engine warming the
  same computation builds no step (``total_compiles() == 0``) and its
  outputs equal a storeless run's bit for bit;
* degrade, never break — a corrupt, truncated, stale or undeserializable
  entry is quarantined and counted, and the step is built as usual; a
  put race is benign; an unwritable store warns and builds;
* key hygiene — interior ``unique_name`` drift leaves the key alone;
  content, mode, shapes and the library fingerprint move it; the key of
  the Program ``from_saved_model`` rebuilds from JSON is the exporter's;
* same answers as the eager step — the persistables a test step writes
  (``auc``'s statistics) reach the scope from a loaded step too, and a
  step that draws random numbers (``sampling_id``) bypasses the store;
* a saved model's embedded store serves only when asked for
  (``compile_store=True``).
"""
import json
import os
import threading

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import serving
from paddle_tpu_torch.io.artifact_store import (
    ArtifactStore, EMBEDDED_DIRNAME, arg_signature, artifact_key,
    canonical_program_repr, library_fingerprint, resolve_store)

torch.set_num_threads(1)


def _build_model():
    """Tiny inference program + initialized private scope."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        h = fluid.layers.fc(input=x, size=6, act="relu",
                            param_attr="w0", bias_attr="b0")
        y = fluid.layers.fc(input=h, size=4, act="softmax",
                            param_attr="w1", bias_attr="b1")
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    return main.clone(for_test=True), scope, [y.name]


def _feed(batch=2, seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(batch, 8).astype(np.float32)}


def _run_with_store(store, program, scope, fetch, feed):
    exe = fluid.Executor(fluid.CPUPlace(), compile_store=store)
    out = exe.run(program, feed=feed, fetch_list=fetch, mode="test",
                  scope=scope)
    return exe, out


def test_canonical_repr_ignores_interior_unique_names():
    prog_a, _, fetch_a = _build_model()
    prog_b, _, fetch_b = _build_model()
    ra = canonical_program_repr(prog_a, fetch_a)
    rb = canonical_program_repr(prog_b, fetch_b)
    assert fetch_a != fetch_b      # the var names really did drift...
    # ...fetch targets stay external, so the reprs differ only there
    assert ra.replace(fetch_a[0], "<F>") == rb.replace(fetch_b[0], "<F>")
    # the Program from_json rebuilds has the same repr
    again = fluid.Program.from_json(prog_a.to_json())
    assert canonical_program_repr(again, fetch_a) == \
        canonical_program_repr(prog_a, fetch_a)


def test_canonical_repr_distinguishes_content():
    prog_a, _, fetch = _build_model()
    prog_b = prog_a.clone(for_test=True)
    for op in prog_b.global_block().ops:
        if op.type == "softmax":
            op.attrs["axis"] = 0
    assert canonical_program_repr(prog_a, fetch) != \
        canonical_program_repr(prog_b, fetch)


def test_artifact_key_sensitivity():
    prog, scope, fetch = _build_model()
    repr_ = canonical_program_repr(prog, fetch)
    state = {n: scope.find_var(n) for n in scope.keys()}
    sig2 = arg_signature(state, {"x": torch.zeros(2, 8)})
    sig4 = arg_signature(state, {"x": torch.zeros(4, 8)})
    fp = library_fingerprint("cpu")
    base = artifact_key(repr_, "test", fetch, 1, True, sig2, fp)
    assert base == artifact_key(repr_, "test", fetch, 1, True, sig2, fp)
    assert base != artifact_key(repr_, "test", fetch, 1, True, sig4, fp)
    assert base != artifact_key(repr_, "train", fetch, 1, True, sig2, fp)
    assert base != artifact_key(repr_, "test", fetch, 2, True, sig2, fp)
    other = dict(fp, torch="0.0.1")
    assert base != artifact_key(repr_, "test", fetch, 1, True, sig2, other)
    assert set(fp) >= {"torch", "cuda", "device", "kernels",
                       "store_schema"}


def test_resolve_store(tmp_path, monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_ARTIFACT_DIR", raising=False)
    assert resolve_store(None) is None and resolve_store(False) is None
    st = resolve_store(str(tmp_path))
    assert isinstance(st, ArtifactStore) and resolve_store(st) is st
    monkeypatch.setenv("PADDLE_TPU_ARTIFACT_DIR", str(tmp_path / "env"))
    assert resolve_store(None).root == str(tmp_path / "env")
    assert resolve_store(False) is None


def test_executor_persists_then_loads_bit_exact(tmp_path):
    store = ArtifactStore(str(tmp_path))
    prog, scope, fetch = _build_model()
    feed = _feed()
    exe0, ref = _run_with_store(False, prog, scope, fetch, feed)
    exe1, out1 = _run_with_store(store, prog, scope, fetch, feed)
    assert exe1.total_compiles() == 1          # the miss built the step
    st = store.stats()
    assert st["misses_total"] == 1 and st["puts_total"] == 1
    assert st["entries"] == 1
    exe2, out2 = _run_with_store(store, prog, scope, fetch, feed)
    assert exe2.total_compiles() == 0          # no step build
    assert exe2.compile_counts() == {}
    assert store.stats()["hits_total"] == 1
    assert np.array_equal(out1[0], out2[0])
    assert np.array_equal(ref[0], out2[0])
    _run_with_store(store, prog, scope, fetch, _feed(4))
    assert store.stats()["misses_total"] == 2
    exe3, _ = _run_with_store(store, prog, scope, fetch, _feed(4))
    assert exe3.total_compiles() == 0


def test_storeless_executor_untouched(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_ARTIFACT_DIR", raising=False)
    prog, scope, fetch = _build_model()
    exe, _ = _run_with_store(None, prog, scope, fetch, _feed())
    assert exe.store_stats() is None and exe.total_compiles() == 1


def test_train_steps_bypass_the_store(tmp_path):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        loss = fluid.layers.mean(fluid.layers.fc(x, size=2))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    store = ArtifactStore(str(tmp_path))
    exe = fluid.Executor(fluid.CPUPlace(), compile_store=store)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    st = store.stats()
    assert st["bypass_total"] >= 2 and st["entries"] == 0


def test_unwritable_store_degrades_to_a_build(tmp_path):
    blocked = tmp_path / "blocked"
    blocked.write_text("not a directory")
    store = ArtifactStore(str(blocked))
    prog, scope, fetch = _build_model()
    with pytest.warns(UserWarning, match="artifact store"):
        exe, out = _run_with_store(store, prog, scope, fetch, _feed())
    assert exe.total_compiles() == 1
    assert store.stats()["put_errors_total"] == 1
    assert np.isfinite(out[0]).all()


def _seed_one(tmp_path):
    store = ArtifactStore(str(tmp_path))
    prog, scope, fetch = _build_model()
    feed = _feed()
    _, out_ref = _run_with_store(store, prog, scope, fetch, feed)
    [entry] = store.entries()
    return store, prog, scope, fetch, feed, out_ref, entry


def _damage(entry, how):
    path = entry["path"]
    mpath = os.path.join(path, "MANIFEST.json")
    if how == "corrupt":
        with open(os.path.join(path, "step.pt2"), "r+b") as f:
            f.seek(10)
            f.write(b"\xff" * 64)
    elif how == "truncated":
        text = open(mpath).read()
        open(mpath, "w").write(text[:len(text) // 2])
    elif how == "stale":
        manifest = json.load(open(mpath))
        manifest["fingerprint"]["torch"] = "0.0.1-somethingelse"
        json.dump(manifest, open(mpath, "w"))
    elif how == "garbage":
        # passes its checksum, will not deserialize
        import hashlib
        blob = b"not an exported program"
        open(os.path.join(path, "step.pt2"), "wb").write(blob)
        manifest = json.load(open(mpath))
        manifest["files"]["step.pt2"]["sha256"] = \
            hashlib.sha256(blob).hexdigest()
        json.dump(manifest, open(mpath, "w"))


@pytest.mark.parametrize("how,counter", [
    ("corrupt", "corrupt_total"), ("truncated", "corrupt_total"),
    ("stale", "stale_total"), ("garbage", "corrupt_total")])
def test_damaged_entry_is_quarantined_and_rebuilt(tmp_path, how, counter):
    store, prog, scope, fetch, feed, out_ref, entry = _seed_one(tmp_path)
    _damage(entry, how)
    with pytest.warns(UserWarning, match="quarantined"):
        exe, out = _run_with_store(store, prog, scope, fetch, feed)
    assert exe.total_compiles() == 1           # built as usual
    st = store.stats()
    assert st[counter] == 1 and st["misses_total"] == 2
    assert np.array_equal(out[0], out_ref[0])
    assert os.listdir(os.path.join(str(tmp_path), "quarantine"))
    # the rebuilt entry was persisted again and loads
    exe2, _ = _run_with_store(store, prog, scope, fetch, feed)
    assert exe2.total_compiles() == 0


def test_concurrent_writers_race_benignly(tmp_path):
    store = ArtifactStore(str(tmp_path))
    store2, prog, scope, fetch, feed, _, entry = _seed_one(
        tmp_path / "seed")
    blob = open(os.path.join(entry["path"], "step.pt2"), "rb").read()
    meta = json.load(open(os.path.join(entry["path"],
                                       "MANIFEST.json")))["meta"]
    fp = library_fingerprint("cpu")
    key = "f" * 64
    n = 6
    results = []
    barrier = threading.Barrier(n)

    def writer():
        barrier.wait()
        results.append(store.save(key, blob, fp, meta=meta))

    threads = [threading.Thread(target=writer) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(results)
    st = store.stats()
    assert st["entries"] == 1 and st["puts_total"] >= 1
    assert st["puts_total"] + st["put_races_total"] == n or \
        st["puts_total"] >= 1
    assert store.load(key) is not None


def test_concurrent_executors_warming_empty_store(tmp_path):
    store = ArtifactStore(str(tmp_path))
    prog, scope, fetch = _build_model()
    feed = _feed()
    outs = [None, None]

    def worker(i):
        _, outs[i] = _run_with_store(store, prog, scope, fetch, feed)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert np.array_equal(outs[0][0], outs[1][0])
    assert store.stats()["entries"] == 1
    exe3, _ = _run_with_store(store, prog, scope, fetch, feed)
    assert exe3.total_compiles() == 0


def test_lru_gc_evicts_oldest(tmp_path):
    store = ArtifactStore(str(tmp_path))
    prog, scope, fetch = _build_model()
    for batch in (1, 2, 3):
        _run_with_store(store, prog, scope, fetch, _feed(batch))
    entries = store.entries()
    assert len(entries) == 3
    per_entry = max(e["bytes"] for e in entries)
    store.cap_bytes = int(per_entry * 2.5)
    _run_with_store(store, prog, scope, fetch, _feed(2))
    _run_with_store(store, prog, scope, fetch, _feed(3))
    evicted = store.gc()
    assert evicted and store.total_bytes() <= store.cap_bytes
    assert store.stats()["evictions_total"] == len(evicted)
    exe2, _ = _run_with_store(store, prog, scope, fetch, _feed(1))
    assert exe2.total_compiles() in (0, 1)


def test_engine_warmup_zero_builds_and_stats(tmp_path):
    prog, scope, fetch = _build_model()
    buckets = serving.BucketSpec(batch_sizes=(1, 2))
    kw = dict(scope=scope, place=fluid.CPUPlace(), buckets=buckets,
              auto_start=False)
    cold = serving.ServingEngine(prog, ["x"], fetch,
                                 compile_store=str(tmp_path), **kw)
    assert cold.warmup()["compiles"] == 2
    warm = serving.ServingEngine(prog, ["x"], fetch,
                                 compile_store=str(tmp_path), **kw)
    assert warm.warmup()["compiles"] == 0
    warm.assert_no_recompiles()
    snap = warm.stats()
    assert snap["artifact_store"]["hits_total"] == 2
    assert snap["compiles_now"] == 0
    warm.start()
    cold.start()
    try:
        a = cold.infer(_feed(1), timeout=30.0)
        b = warm.infer(_feed(1), timeout=30.0)
        assert np.array_equal(a[0], b[0])
        warm.assert_no_recompiles()
    finally:
        cold.close()
        warm.close()


def _saved_fc_model(tmp_path, batches):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        y = fluid.layers.fc(input=x, size=4, act="softmax")
    exe = fluid.Executor(fluid.CPUPlace())
    model_dir = str(tmp_path / "model")
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(
            model_dir, ["x"], [y], exe, main_program=main,
            serving_buckets=serving.BucketSpec(batch_sizes=batches),
            artifact_store=True)
    return model_dir


def test_saved_model_embedded_store_roundtrip(tmp_path, monkeypatch):
    """save_inference_model(artifact_store=True) seeds __artifacts__/
    inside the saved dir by replaying from_saved_model + warmup();
    from_saved_model(compile_store=True) warms from it with zero builds,
    bit for bit the storeless engine's, which is the default."""
    monkeypatch.delenv("PADDLE_TPU_ARTIFACT_DIR", raising=False)
    model_dir = _saved_fc_model(tmp_path, (1, 2))
    entries = ArtifactStore(os.path.join(model_dir,
                                         EMBEDDED_DIRNAME)).entries()
    assert len(entries) == 2
    # an entry holds the step's graph, not its example inputs
    import zipfile
    for e in entries:
        with zipfile.ZipFile(os.path.join(e["path"], "step.pt2")) as z:
            assert not [n for n in z.namelist() if "example_inputs" in n
                        and z.getinfo(n).file_size > 1024]
    eng = serving.ServingEngine.from_saved_model(
        model_dir, place=fluid.CPUPlace(), compile_store=True,
        auto_start=False)
    report = eng.warmup()
    assert report["compiles"] == 0 and eng.exe.total_compiles() == 0
    st = eng.stats()["artifact_store"]
    assert st["hits_total"] == report["signatures"] == 2
    assert st["misses_total"] == 0
    ref = serving.ServingEngine.from_saved_model(
        model_dir, place=fluid.CPUPlace(), auto_start=False)
    assert ref.exe.store_stats() is None     # the store is opt-in
    assert ref.warmup()["compiles"] == 2
    feed = _feed(2)
    a = eng.exe.run(eng.program, feed=feed, fetch_list=eng.fetch_list,
                    mode="test", scope=eng.scope)
    b = ref.exe.run(ref.program, feed=feed, fetch_list=ref.fetch_list,
                    mode="test", scope=ref.scope)
    assert np.array_equal(a[0], b[0])
    assert eng.exe.total_compiles() == 0
    eng.close()
    ref.close()


def test_inferencer_picks_up_embedded_store(tmp_path, monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_ARTIFACT_DIR", raising=False)
    model_dir = _saved_fc_model(tmp_path, (1,))
    inf = fluid.Inferencer.from_saved_model(model_dir,
                                            place=fluid.CPUPlace())
    assert inf.artifact_dir == os.path.join(model_dir, EMBEDDED_DIRNAME)
    eng = inf.serve(warmup=True, auto_start=False, compile_store=True)
    assert eng.exe.total_compiles() == 0
    assert eng.stats()["artifact_store"]["hits_total"] == 1
    eng.close()
    plain = inf.serve(warmup=True, auto_start=False)
    assert plain.exe.store_stats() is None
    assert plain.exe.total_compiles() == 1
    plain.close()


def test_compile_store_true_needs_an_embedded_store(tmp_path):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        y = fluid.layers.fc(input=x, size=4)
    exe = fluid.Executor(fluid.CPUPlace())
    model_dir = str(tmp_path / "model")
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(model_dir, ["x"], [y], exe,
                                      main_program=main)
    with pytest.raises(FileNotFoundError, match="embedded artifact store"):
        serving.ServingEngine.from_saved_model(
            model_dir, place=fluid.CPUPlace(), compile_store=True,
            auto_start=False)
    inf = fluid.Inferencer.from_saved_model(model_dir,
                                            place=fluid.CPUPlace())
    with pytest.raises(ValueError, match="embedded artifact store"):
        inf.serve(compile_store=True, auto_start=False)
    with pytest.raises(ValueError, match="embedded artifact store"):
        fluid.Executor(fluid.CPUPlace(), compile_store=True)


def _auc_program():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        lbl = fluid.layers.data(name="lbl", shape=[1], dtype="int64")
        prob = fluid.layers.fc(input=x, size=2, act="softmax",
                               param_attr="w", bias_attr="b")
        auc, stats = fluid.layers.auc(prob, lbl, num_thresholds=15)
    return main.clone(for_test=True), startup, auc, stats


def test_store_writes_persistables_like_the_eager_step(tmp_path):
    """auc's statistics are persistables its test step writes: over two
    batches, a step from the store (the exporting miss, then a new
    executor's hit) leaves the same AUC fetches and the same scope as
    the eager step, bit for bit."""
    prog, startup, auc, stats = _auc_program()
    rng = np.random.RandomState(3)
    feeds = [{"x": rng.randn(6, 8).astype(np.float32),
              "lbl": rng.randint(0, 2, (6, 1)).astype(np.int64)}
             for _ in range(2)]
    store = ArtifactStore(str(tmp_path))
    runs = {}
    for name, spec in (("eager", False), ("miss", store), ("hit", store)):
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace(), compile_store=spec)
        exe.run(startup, scope=scope)
        scope.set("w", torch.linspace(-1, 1, 16).reshape(8, 2))
        scope.set("b", torch.zeros(2))
        outs = [exe.run(prog, feed=f, fetch_list=[auc], mode="test",
                        scope=scope)[0] for f in feeds]
        runs[name] = (outs, [to_np(scope.find_var(v.name))
                             for v in stats], exe)
    st = store.stats()
    assert st["misses_total"] == 1 and st["hits_total"] == 1
    # the startup program's step, and the test step but from the store
    assert runs["eager"][2].total_compiles() == 2
    assert runs["hit"][2].total_compiles() == 1
    eager_outs, eager_stats, _ = runs["eager"]
    # both batches' 6 samples are in the histograms
    assert eager_stats[0].sum() + eager_stats[1].sum() == 12
    for name in ("miss", "hit"):
        outs, st, _ = runs[name]
        assert all(np.array_equal(a, b) for a, b in zip(outs, eager_outs))
        assert all(np.array_equal(a, b) for a, b in zip(st, eager_stats))


def test_rng_steps_bypass_the_store(tmp_path):
    """sampling_id draws a new sample each dispatch from the executor's
    (seed, step) stream; an exported step has no seed or step input, so
    such a step runs eagerly: over two dispatches the store gives the
    storeless executor's draws and holds no entry."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[32], dtype="float32")
        ids = fluid.layers.sampling_id(fluid.layers.softmax(x))
    main.random_seed = 7
    prog = main.clone(for_test=True)
    feed = {"x": np.zeros((64, 32), np.float32)}
    draws = {}
    for name, spec in (("eager", False), ("store", str(tmp_path))):
        exe = fluid.Executor(fluid.CPUPlace(), compile_store=spec)
        scope = fluid.Scope()
        draws[name] = [exe.run(prog, feed=feed, fetch_list=[ids],
                               mode="test", scope=scope)[0]
                       for _ in range(2)]
        if spec:
            st = exe.store_stats()
            assert st["bypass_total"] == 2 and st["entries"] == 0
    assert not np.array_equal(*draws["eager"])   # two different draws
    assert all(np.array_equal(a, b)
               for a, b in zip(draws["eager"], draws["store"]))


def to_np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)
