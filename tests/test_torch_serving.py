"""The port's serving engine (paddle_tpu_torch/inference/serving/)
against the JAX package's (paddle_tpu/inference/serving/), on the CPU.

The JAX package builds and exports the book LM at its own test size
(vocab 29, hidden 8, 2 layers, BucketSpec(batch=3, prefill_lens=(8,),
cache_lens=(24,))); the port loads that directory on CPUPlace():

* prefill's logits and k/v and decode's logits and new k/v within TOL
  (1e-5) of the JAX FrozenServingModel's on the same seeded feeds, and
  reference_generate's tokens equal in both packages for the three
  prompts of tests/test_serving.py; a directory the port exports loads
  in the JAX package with the same numbers;
* one case for each test of tests/test_serving.py, run on the port's
  ServingEngine, ServeServer, fault plan and spans: continuous batching
  bit-identical to reference_generate, joins, the KV pages in the
  memory census, deadline / quota / too_long statuses, quota refunds,
  tenant caps, preemption, a killed runner, the RPC server, SIGTERM
  drain, the request's spans;
* warmup() leaves each signature captured: a burst plans, captures and
  runs eagerly nothing;
* unsqueeze2 against the JAX op, and PagedKVCache's gather and scatter
  against a dense numpy cache (dead rows on the scratch page, live
  slots never shared).
"""
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.inference import serving as jserving

import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed import faults
from paddle_tpu_torch.distributed.faults import FaultPlan
from paddle_tpu_torch.distributed.resilience import endpoint_health
from paddle_tpu_torch.inference.serving import (
    BucketSpec, PagedKVCache, ServeServer, ServingEngine, TenantQuota,
    build_book_lm, export_serving_model, generate, load_serving_model,
    reference_generate, resolve_serving_mesh, serve_rpc, STATUS_DEADLINE,
    STATUS_FAILED, STATUS_OK, STATUS_QUEUE_FULL, STATUS_QUOTA)
from paddle_tpu_torch.inference.serving import export as pexport
from paddle_tpu_torch.observability import memory as obs_memory
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.observability import tracing
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
BATCH = 3
MAX_NEW = 5
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9]]
CPU = pt.CPUPlace()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The JAX package exports the book LM once; the port loads it
    (warmed up), and so does the JAX package."""
    fluid.framework.unique_name.reset()
    d = str(tmp_path_factory.mktemp("serve") / "model")
    prefill, decode, startup, meta = jserving.build_book_lm(
        vocab=29, hidden=8, num_layers=2, max_len=64)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    bk = jserving.BucketSpec(batch=BATCH, prefill_lens=(8,),
                             cache_lens=(24,))
    jserving.export_serving_model(d, exe, prefill, decode, meta, buckets=bk)
    model = load_serving_model(d, place=CPU)
    assert model.warmup() == 2
    return d, model


@pytest.fixture(scope="module")
def jmodel(served):
    return jserving.load_serving_model(served[0])


def _run(eng, max_steps=200):
    steps = 0
    while eng.pending() and steps < max_steps:
        eng.step()
        steps += 1
    assert not eng.pending(), "engine did not drain"
    return steps


def _refs(model):
    return [reference_generate(model, p, MAX_NEW) for p in PROMPTS]


def _feeds(seed):
    """Seeded prefill and decode feeds at the bucket shapes, with random
    cache contents."""
    r = np.random.RandomState(seed)
    tokens, pos, mask = pexport.prefill_feeds(PROMPTS, 8, BATCH)
    S = 24
    cache_k = r.randn(2, BATCH, S, 8).astype(np.float32)
    cache_v = r.randn(2, BATCH, S, 8).astype(np.float32)
    token, dpos, dmask = pexport.decode_feeds([3, 9, 11], [4, 7, 20], S,
                                              BATCH)
    return (tokens, pos, mask), (token, dpos, dmask, cache_k, cache_v)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# cross-package parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_decode_match_jax_export(served, jmodel, seed):
    _, model = served
    pre, dec = _feeds(seed)
    for got, ref in zip(model.prefill(*pre), jmodel.prefill(*pre)):
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=TOL,
                                   atol=TOL)
    token, dpos, dmask, ck, cv = dec
    got = model.decode(token, dpos, dmask, torch.from_numpy(ck),
                       torch.from_numpy(cv))
    ref = jmodel.decode(token, dpos, dmask, ck, cv)
    assert got[0].shape == (BATCH, 29) and got[1].shape == (2, BATCH, 8)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_np(g), np.asarray(r), rtol=TOL,
                                   atol=TOL)


def test_prefill_rows_pick_prefill_logits(served):
    _, model = served
    pre, _ = _feeds(2)
    full, k, v = model.prefill(*pre)
    rows = [2, 1, 3]
    picked, k2, v2 = model.prefill_rows(*pre, rows)
    assert np.array_equal(picked, full[np.arange(BATCH), rows])
    assert torch.equal(k, k2) and torch.equal(v, v2)


def test_reference_generate_matches_jax(served, jmodel):
    _, model = served
    for p in PROMPTS:
        assert reference_generate(model, p, MAX_NEW) == \
            jserving.reference_generate(jmodel, p, MAX_NEW)


def test_port_export_loads_in_jax(tmp_path):
    """The port builds, initializes and exports; the JAX package loads
    the directory and serves the same numbers."""
    pt.framework.unique_name.reset()
    d = str(tmp_path / "model")
    prefill, decode, startup, meta = build_book_lm(
        vocab=29, hidden=8, num_layers=2, max_len=64)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe = pt.Executor(CPU)
        exe.run(startup)
        export_serving_model(d, exe, prefill, decode, meta,
                             buckets=BucketSpec(BATCH, (8,), (24,)))
    assert sorted(os.listdir(d)) == ["decode", "prefill", "serving.json"]
    model = load_serving_model(d, place=CPU)
    jm = jserving.load_serving_model(d)
    pre, dec = _feeds(3)
    for got, ref in zip(model.prefill(*pre), jm.prefill(*pre)):
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=TOL,
                                   atol=TOL)
    token, dpos, dmask, ck, cv = dec
    got = model.decode(token, dpos, dmask, ck, cv)
    ref = jm.decode(token, dpos, dmask, ck, cv)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_np(g), np.asarray(r), rtol=TOL,
                                   atol=TOL)
    assert reference_generate(model, PROMPTS[0], MAX_NEW) == \
        jserving.reference_generate(jm, PROMPTS[0], MAX_NEW)


def test_unsqueeze2_matches_jax():
    from paddle_tpu import layers as jlayers
    x = np.random.RandomState(4).randn(3, 5).astype(np.float32)
    outs = []
    for pkg, layers, exe_place in ((fluid, jlayers, fluid.CPUPlace()),
                                   (pt, pt.layers, CPU)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            xv = layers.data("x", [5], dtype="float32")
            y = layers.unsqueeze(xv, [0, 2])
            z = layers.unsqueeze(xv, [-1])
        assert main.global_block().ops[0].type == "unsqueeze2"
        assert tuple(y.shape) == (1, -1, 1, 5)
        exe = pkg.Executor(exe_place)
        outs.append([np.asarray(o) for o in exe.run(
            main, feed={"x": x}, fetch_list=[y, z])])
    for got, ref in zip(outs[1], outs[0]):
        assert got.shape == ref.shape
        assert np.array_equal(got, ref)


def test_lookup_table_squeezes_trailing_id_dim():
    """The decode program's [B,1] token ids embed to [B,H] (the trailing
    1 squeezed, as in the JAX lowering); unsqueeze restores [B,1,H]."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        ids = pt.layers.data("ids", [1], dtype="int64")
        emb = pt.layers.embedding(ids, size=[7, 4])
        h = pt.layers.unsqueeze(emb, [1])
    assert tuple(emb.shape) == (-1, 4) and tuple(h.shape) == (-1, 1, 4)
    exe = pt.Executor(CPU)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe.run(startup)
        out, = exe.run(main, feed={"ids": np.array([[1], [6]], np.int64)},
                       fetch_list=[h])
    assert out.shape == (2, 1, 4)


# ---------------------------------------------------------------------------
# the paged cache
# ---------------------------------------------------------------------------

def test_paged_kv_cache_against_dense_numpy():
    r = np.random.RandomState(5)
    L, H, ps = 2, 3, 4
    kv = PagedKVCache(L, H, num_pages=9, page_size=ps, device="cpu")
    dense_k, dense_v = {}, {}
    lens = {10: 6, 11: 3, 12: 9}
    for sid, n in lens.items():
        assert kv.allocate(sid, n + 3)
    seq_ids = [10, None, 11, 12]
    B, S = len(seq_ids), 9
    k_rows = r.randn(L, B, S, H).astype(np.float32)
    v_rows = r.randn(L, B, S, H).astype(np.float32)
    plens = [lens[s] if s is not None else 0 for s in seq_ids]
    kv.write_rows(seq_ids, torch.from_numpy(k_rows),
                  torch.from_numpy(v_rows), plens)
    for b, sid in enumerate(seq_ids):
        if sid is not None:
            dense_k[sid] = k_rows[:, b, :lens[sid]].copy()
            dense_v[sid] = v_rows[:, b, :lens[sid]].copy()
    # one appended token a live row; the dead row's goes to scratch
    k_new = r.randn(L, B, H).astype(np.float32)
    v_new = r.randn(L, B, H).astype(np.float32)
    kv.append(seq_ids, torch.from_numpy(k_new), torch.from_numpy(v_new))
    for b, sid in enumerate(seq_ids):
        if sid is not None:
            dense_k[sid] = np.concatenate([dense_k[sid], k_new[:, b, None]],
                                          axis=1)
            dense_v[sid] = np.concatenate([dense_v[sid], v_new[:, b, None]],
                                          axis=1)
    width = 12
    ck, cv = kv.gather(seq_ids, width)
    assert tuple(ck.shape) == (L, B, width, H)
    slots = kv.slot_matrix(seq_ids, width)
    live = slots[slots != 0]
    assert len(np.unique(live)) == len(live)        # no live collision
    assert (live >= ps).all()                       # never the scratch page
    for b, sid in enumerate(seq_ids):
        if sid is None:
            assert (slots[b] == 0).all()
            continue
        n = kv.seq_len(sid)
        assert n == lens[sid] + 1
        np.testing.assert_array_equal(ck[:, b, :n].numpy(), dense_k[sid])
        np.testing.assert_array_equal(cv[:, b, :n].numpy(), dense_v[sid])
        assert (slots[b, n:] == 0).all()
    # a live slot written twice in one dispatch is refused
    with pytest.raises(RuntimeError, match="live rows"):
        kv.append([10, 10], torch.zeros(L, 2, H), torch.zeros(L, 2, H))
    assert kv.free(11) == kv.pages_needed(lens[11] + 3)
    assert kv.live_seqs() == [10, 12]


# ---------------------------------------------------------------------------
# the engine, one case for each test of tests/test_serving.py
# ---------------------------------------------------------------------------

def test_export_artifacts(tmp_path):
    """The export's directories, and no AOT artifact after the port
    served from them (a CUDA graph has no on-disk form)."""
    pt.framework.unique_name.reset()
    d = str(tmp_path / "model")
    prefill, decode, startup, meta = build_book_lm(
        vocab=29, hidden=8, num_layers=2, max_len=64)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe = pt.Executor(CPU)
        exe.run(startup)
        export_serving_model(d, exe, prefill, decode, meta,
                             buckets=BucketSpec(BATCH, (8,), (24,)))
    before = sorted(os.path.relpath(os.path.join(r, f), d)
                    for r, _, fs in os.walk(d) for f in fs)
    model = load_serving_model(d, place=CPU)
    assert model.warmup() == 2
    assert reference_generate(model, PROMPTS[0], MAX_NEW)
    after = sorted(os.path.relpath(os.path.join(r, f), d)
                   for r, _, fs in os.walk(d) for f in fs)
    assert sorted(os.listdir(d)) == ["decode", "prefill", "serving.json"]
    assert "prefill/__model__" in after and "decode/__model__" in after
    assert after == before


def test_warmup_captures_every_signature(served):
    """After warmup() a burst plans, captures and runs eagerly nothing:
    every dispatch replays."""
    _, model = served
    before = dict(model.engine_counters())
    eng = ServingEngine(model)
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=MAX_NEW)
    _run(eng)
    after = model.engine_counters()
    assert after["captures"] == before["captures"]
    assert after["eager_runs"] == before["eager_runs"]
    assert after["traces"] == before["traces"]
    assert after["replays"] > before["replays"]


def test_continuous_batching_parity(served):
    _, model = served
    eng = ServingEngine(model)
    reqs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in PROMPTS]
    _run(eng)
    assert max(eng.occupancy_history) > 1
    for r, ref in zip(reqs, _refs(model)):
        assert r.status == STATUS_OK
        assert r.tokens == ref


def test_join_at_step_granularity(served):
    _, model = served
    eng = ServingEngine(model)
    r1 = eng.submit(PROMPTS[0], max_new_tokens=MAX_NEW)
    eng.step()
    eng.step()
    assert len(eng.occupancy_history) >= 1 and \
        max(eng.occupancy_history) == 1
    r2 = eng.submit(PROMPTS[2], max_new_tokens=MAX_NEW)
    _run(eng)
    refs = _refs(model)
    assert r1.tokens == refs[0] and r2.tokens == refs[2]
    assert max(eng.occupancy_history) == 2


def test_kv_pages_census_attributed_and_freed(served):
    _, model = served
    eng = ServingEngine(model)
    eng.submit(PROMPTS[0], max_new_tokens=MAX_NEW)
    eng.step()
    assert eng.kv.pages_in_use > 0
    c = obs_memory.census(top_n=256)
    kv = c["owners"].get("kv_cache")
    assert kv is not None and kv["count"] >= 2 and kv["bytes"] > 0
    labels = {b["label"] for b in c["top_buffers"]
              if b["owner"] == "kv_cache"}
    assert {"k_pages", "v_pages"} <= labels
    assert c["owners"].get("predictor", {}).get("count", 0) > 0
    assert obs_metrics.gauge("pt_hbm_owner_bytes").get(owner="kv_cache") \
        == kv["bytes"]
    _run(eng)
    assert eng.kv.pages_in_use == 0
    assert eng.kv.live_seqs() == []


def test_deadline_and_quota_distinct_statuses(served):
    _, model = served
    quota = TenantQuota(max_concurrent=4, token_budget=9)
    eng = ServingEngine(model, quotas={"t0": quota})
    rej = obs_metrics.counter("pt_serve_rejections_total")
    quota_before = rej.get(reason="quota")
    r_quota = eng.submit(PROMPTS[0], max_new_tokens=7, tenant="t0")
    assert r_quota.status == STATUS_QUOTA
    assert r_quota.done.is_set() and r_quota.tokens == []
    assert rej.get(reason="quota") == quota_before + 1
    r_dead = eng.submit(PROMPTS[1], max_new_tokens=MAX_NEW,
                        deadline_s=-0.01)
    eng.step()
    assert r_dead.status == STATUS_DEADLINE
    assert r_dead.status != r_quota.status
    r_ok = eng.submit(PROMPTS[1], max_new_tokens=MAX_NEW, tenant="t0",
                      deadline_s=60.0)
    _run(eng)
    assert r_ok.status == STATUS_OK
    assert r_ok.tokens == _refs(model)[1]


def test_overlong_prompt_rejected_not_crash(served):
    _, model = served
    eng = ServingEngine(model)
    rej = obs_metrics.counter("pt_serve_rejections_total")
    before = rej.get(reason="too_long")
    r = eng.submit(list(range(1, 10)), max_new_tokens=2)
    assert r.status == STATUS_QUEUE_FULL and r.done.is_set()
    assert rej.get(reason="too_long") == before + 1
    assert eng.kv.pages_in_use == 0
    ok = eng.submit(PROMPTS[0], max_new_tokens=MAX_NEW)
    _run(eng)
    assert ok.status == STATUS_OK
    assert ok.tokens == _refs(model)[0]


def test_quota_refund_on_non_ok_retirement(served):
    _, model = served
    quota = TenantQuota(max_concurrent=4, token_budget=8)
    eng = ServingEngine(model, quotas={"t2": quota})
    dead = eng.submit(PROMPTS[1], max_new_tokens=MAX_NEW, tenant="t2",
                      deadline_s=-0.01)
    assert quota.used_tokens == 7
    eng.step()
    assert dead.status == STATUS_DEADLINE
    assert quota.used_tokens == 0
    ok = eng.submit(PROMPTS[1], max_new_tokens=MAX_NEW, tenant="t2")
    _run(eng)
    assert ok.status == STATUS_OK
    assert ok.tokens == _refs(model)[1]
    assert quota.used_tokens == 7


def test_saturated_tenant_does_not_block_others(served):
    _, model = served
    eng = ServingEngine(model, quotas={"t1": TenantQuota(max_concurrent=1)})
    r1 = eng.submit(PROMPTS[0], max_new_tokens=MAX_NEW, tenant="t1")
    r2 = eng.submit(PROMPTS[1], max_new_tokens=MAX_NEW, tenant="t1")
    r3 = eng.submit(PROMPTS[2], max_new_tokens=MAX_NEW, tenant="other")
    eng.step()
    assert max(eng.occupancy_history) == 2
    _run(eng)
    refs = _refs(model)
    assert [r.status for r in (r1, r2, r3)] == [STATUS_OK] * 3
    assert [r.tokens for r in (r1, r2, r3)] == refs


def test_occupancy_history_bounded(served):
    _, model = served
    assert ServingEngine(model).occupancy_history.maxlen is not None


def test_concurrency_limit_queues_not_rejects(served):
    _, model = served
    eng = ServingEngine(model, quotas={"t1": TenantQuota(max_concurrent=1)})
    r1 = eng.submit(PROMPTS[0], max_new_tokens=MAX_NEW, tenant="t1")
    r2 = eng.submit(PROMPTS[1], max_new_tokens=MAX_NEW, tenant="t1")
    eng.step()
    assert max(eng.occupancy_history) == 1
    _run(eng)
    refs = _refs(model)
    assert (r1.status, r2.status) == (STATUS_OK, STATUS_OK)
    assert r1.tokens == refs[0] and r2.tokens == refs[1]


def test_preemption_under_memory_pressure(served):
    _, model = served
    kv = PagedKVCache(model.num_layers, model.hidden, num_pages=3,
                      page_size=4, device=model.device)
    eng = ServingEngine(model, kv=kv)
    ev = obs_metrics.counter("pt_serve_kv_evictions_total")
    ev_before = ev.get()
    lo = eng.submit(PROMPTS[0], max_new_tokens=MAX_NEW, priority=0)
    eng.step()
    hi = eng.submit(PROMPTS[1], max_new_tokens=MAX_NEW, priority=5)
    _run(eng)
    assert ev.get() == ev_before + 1
    assert lo.preemptions == 1
    refs = _refs(model)
    assert hi.status == STATUS_OK and hi.tokens == refs[1]
    assert lo.status == STATUS_OK and lo.tokens == refs[0]
    assert kv.pages_in_use == 0


def test_fault_kill_mid_decode_contained(served):
    _, model = served
    eng = ServingEngine(model)
    reqs_total = obs_metrics.counter("pt_serve_requests_total")
    failed_before = reqs_total.get(status=STATUS_FAILED)
    br = endpoint_health.get("serve:runner")
    with faults.scoped(FaultPlan(serve_kill_decode=1,
                                 serve_kill_attempts=1)):
        r1 = eng.submit(PROMPTS[0], max_new_tokens=MAX_NEW)
        r2 = eng.submit(PROMPTS[1], max_new_tokens=MAX_NEW)
        _run(eng)
    assert r1.status == STATUS_FAILED and r2.status == STATUS_FAILED
    assert reqs_total.get(status=STATUS_FAILED) == failed_before + 2
    assert eng.kv.pages_in_use == 0
    assert br.state in ("closed", "open")
    r3 = eng.submit(PROMPTS[2], max_new_tokens=MAX_NEW)
    _run(eng)
    assert r3.status == STATUS_OK
    assert r3.tokens == _refs(model)[2]


def test_fault_plan_env_spec_roundtrip(monkeypatch):
    plan = FaultPlan.from_spec("serve_kill_decode=3,serve_kill_attempts=2")
    assert plan.serve_kill_decode == 3
    assert plan.on_serve_decode(2) is False
    assert plan.on_serve_decode(3) is True
    assert plan.on_serve_decode(3) is True
    assert plan.on_serve_decode(9) is False
    monkeypatch.setenv("PT_FAULT_PLAN", "seed=7,serve_kill_decode=4")
    env = FaultPlan.from_env()
    assert (env.seed, env.serve_kill_decode) == (7, 4)
    with pytest.raises(ValueError, match="unknown fault-plan key"):
        FaultPlan.from_spec("serve_kill_decod=3")
    with pytest.raises(NotImplementedError, match="A.9"):
        FaultPlan.from_spec("kill_at_step=3")


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_server_multi_tenant_end_to_end(served):
    _, model = served
    eng = ServingEngine(
        model, quotas={"paid": TenantQuota(max_concurrent=4),
                       "free": TenantQuota(token_budget=9)})
    ep = f"127.0.0.1:{_free_port()}"
    srv = ServeServer(ep, eng).start()
    try:
        out = generate(ep, PROMPTS[0], max_new_tokens=MAX_NEW,
                       tenant="paid", timeout=60.0)
        assert out["status"] == STATUS_OK
        assert out["tokens"] == _refs(model)[0]
        over = generate(ep, PROMPTS[0], max_new_tokens=7, tenant="free",
                        timeout=60.0)
        assert over["status"] == STATUS_QUOTA and over["tokens"] == []
        st = serve_rpc(ep, {"t": "stats"}, timeout=10.0)
        assert st["pending"] == 0
        assert st["kv"]["pages_in_use"] == 0
        assert serve_rpc(ep, {"t": "ping"}, timeout=10.0) == "pong"
    finally:
        assert srv.shutdown() is True
    late = eng.submit(PROMPTS[0], max_new_tokens=2)
    assert late.status is not None and late.done.is_set()


def test_malformed_request_gets_error_reply(served):
    _, model = served
    eng = ServingEngine(model)
    ep = f"127.0.0.1:{_free_port()}"
    srv = ServeServer(ep, eng).start()
    try:
        out = serve_rpc(ep, {"t": "gen"}, timeout=10.0)
        assert isinstance(out, dict) and "KeyError" in out["err"]
        ok = generate(ep, PROMPTS[0], max_new_tokens=MAX_NEW, timeout=60.0)
        assert ok["status"] == STATUS_OK
        assert ok["tokens"] == _refs(model)[0]
    finally:
        srv.shutdown()


def test_server_sigterm_graceful_drain(served):
    _, model = served
    eng = ServingEngine(model)
    ep = f"127.0.0.1:{_free_port()}"
    srv = ServeServer(ep, eng).start()
    prev = signal.getsignal(signal.SIGTERM)
    try:
        assert srv.install_signal_handlers()
        results = {}

        def client():
            results["out"] = generate(ep, PROMPTS[1],
                                      max_new_tokens=MAX_NEW, timeout=60.0)

        t = threading.Thread(target=client)
        t.start()
        while not eng.pending():
            time.sleep(0.002)
        os.kill(os.getpid(), signal.SIGTERM)
        t.join(timeout=60.0)
        assert results["out"]["status"] == STATUS_OK
        assert results["out"]["tokens"] == _refs(model)[1]
        for _ in range(500):
            if srv._stop.is_set():
                break
            time.sleep(0.01)
        assert srv._stop.is_set()
    finally:
        signal.signal(signal.SIGTERM, prev)
        srv.shutdown()


def test_tracing_spans_cover_request_lifecycle(served):
    _, model = served
    obs_metrics.enable_telemetry(True)
    tracing.clear_spans()
    try:
        eng = ServingEngine(model)
        req = eng.submit(PROMPTS[0], max_new_tokens=MAX_NEW)
        _run(eng)
        assert req.status == STATUS_OK
        names = [s["name"] for s in tracing.spans_snapshot()
                 if s.get("trace") == req.trace]
        assert "serve.admission" in names
        assert "serve.prefill" in names
        assert names.count("serve.decode_step") == MAX_NEW - 1
        assert "serve.complete" in names
    finally:
        obs_metrics.enable_telemetry(False)
        tracing.clear_spans()


def test_rpc_spans_correlate_client_and_server(served):
    """With telemetry on, a generate call records a client span and a
    server span parented under it, in one trace."""
    _, model = served
    eng = ServingEngine(model)
    ep = f"127.0.0.1:{_free_port()}"
    srv = ServeServer(ep, eng).start()
    obs_metrics.enable_telemetry(True)
    tracing.clear_spans()
    try:
        out = generate(ep, PROMPTS[2], max_new_tokens=2, timeout=60.0)
        assert out["status"] == STATUS_OK
        # the handler records its span after the reply went out
        for _ in range(500):
            spans = tracing.spans_snapshot()
            server = [s for s in spans if s["name"] == "serve.gen"]
            if server:
                break
            time.sleep(0.01)
        client = [s for s in spans if s["kind"] == "rpc.client"]
        assert len(client) == 1 and len(server) == 1
        assert server[0]["parent"] == client[0]["span"]
        assert server[0]["trace"] == client[0]["trace"]
    finally:
        obs_metrics.enable_telemetry(False)
        tracing.clear_spans()
        srv.shutdown()


def test_serving_mesh_spec_on_one_device(monkeypatch):
    assert resolve_serving_mesh("") is None
    with pytest.warns(UserWarning, match="serving unsharded"):
        assert resolve_serving_mesh("tp=2") is None
    with pytest.raises(ValueError, match="unknown serving mesh axis"):
        resolve_serving_mesh("pp=2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(NotImplementedError, match="A.7"):
        resolve_serving_mesh("tp=2")


def test_metrics_registry_and_span_dumps(served, tmp_path):
    """The registry collects the serving families and the RPC breaker
    states; a step context opened with begin_step parents the RPC's
    client and server spans; the span ring dumps and reads back."""
    _, model = served
    eng = ServingEngine(model)
    ep = f"127.0.0.1:{_free_port()}"
    srv = ServeServer(ep, eng).start()
    obs_metrics.enable_telemetry(True)
    tracing.clear_spans()
    try:
        trace = tracing.begin_step(7)
        assert trace.endswith("-7")
        assert tracing.current_context()["trace"] == trace
        out = generate(ep, PROMPTS[0], max_new_tokens=2, timeout=60.0)
        tracing.end_step()
        assert tracing.current_context() is None
        assert out["status"] == STATUS_OK
        for _ in range(500):
            named = {s["name"]: s for s in tracing.spans_snapshot()}
            if "serve.gen" in named:
                break
            time.sleep(0.01)
        assert named["rpc.gen"]["trace"] == trace
        assert named["serve.gen"]["trace"] == trace
        assert named["serve.gen"]["parent"] == named["rpc.gen"]["span"]
        path = tracing.dump_spans("test", directory=str(tmp_path))
        dumped = tracing.read_span_dump(path)
        assert dumped["header"]["reason"] == "test"
        assert {s["name"] for s in dumped["spans"]} >= {"rpc.gen",
                                                        "serve.gen"}
        assert tracing.find_span_dumps(str(tmp_path)) == [path]
    finally:
        tracing.end_step()
        obs_metrics.enable_telemetry(False)
        tracing.clear_spans()
        srv.shutdown()
    fams = {f.name: f for f in obs_metrics.default_registry().collect()}
    assert fams["pt_serve_tokens_total"].type == "counter"
    assert fams["pt_serve_request_seconds"].samples[0][1].count > 0
    eps = {lb.get("endpoint") for lb, _ in
           fams["pt_rpc_breaker_state"].samples}
    assert ep in eps
    assert "pt_rpc_retries_total" in fams
