"""The port's serving slice (serving.server, executor.server,
executor.llm_bridge) against the JAX package's, on the CPU at small size.

* ``sample_token``: greedy; ``top_k`` restricts the support; a tiny
  ``top_p`` is greedy (the reference's ``test_system.py`` cases, with a
  ``torch.Generator`` for the draws).
* ``BatchedServer``: greedy tokens equal to the reference's for the same
  requests on an f32 config (slots recycled); ``run_until_drained``
  returns the finished requests; the KV reservation comes back.
* ``ColdServer``: ``test_cold_server.py``'s admission, no-crosstalk, LRU
  eviction and shared-ProfileDB cases, with ``SyntheticProfiler`` plans.
* ``cold_start_llm`` on ``tiny_llm_graph(4)``: the ordering gates; under
  one plan (``SyntheticProfiler``, the same in both packages) the first
  token and the greedy continuation equal to the reference's; under an
  int8 and an int4 plan the packed decode params equal, bit for bit, the
  reference's ``_expand_quantized`` output cast to bf16.
"""
import threading
import time
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core.engine import ColdEngine as RefEngine  # noqa: E402
from repro.core.llm_graph import TBlockInt4 as RefTBlockInt4  # noqa: E402
from repro.core.llm_graph import TBlockInt8 as RefTBlockInt8  # noqa: E402
from repro.core.llm_graph import build_llm_graph as ref_build  # noqa: E402
from repro.core.profiler import SyntheticProfiler as RefSynthetic  # noqa: E402
from repro.executor import llm_bridge as RB  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.serving import BatchedServer as RefServer  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402
from repro_torch import bf16  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import llm_graph as LG  # noqa: E402
from repro_torch.core.engine import ColdEngine  # noqa: E402
from repro_torch.core.pipeline import PipelineRuntime  # noqa: E402
from repro_torch.core.profiler import SyntheticProfiler  # noqa: E402
from repro_torch.core.scheduler import Choice  # noqa: E402
from repro_torch.executor import llm_bridge as PB  # noqa: E402
from repro_torch.executor.server import ColdServer, MemoryBudget  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.cnn import build_cnn  # noqa: E402
from repro_torch.serving import BatchedServer, Request  # noqa: E402
from repro_torch.serving.server import sample_token  # noqa: E402

torch.set_num_threads(1)

TINY = dict(num_layers=4, d_model=128, d_ff=256, num_heads=2,
            num_kv_heads=1, head_dim=64, vocab_size=512)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------
LOGITS = torch.tensor([0.1, 5.0, 0.2, 4.9, -3.0])


def test_sample_token_greedy():
    assert int(sample_token(LOGITS)) == 1
    assert int(sample_token(LOGITS.to(torch.bfloat16))) == 1


def test_sample_token_top_k_restricts_support():
    g = torch.Generator().manual_seed(0)
    draws = {int(sample_token(LOGITS, g, temperature=1.0, top_k=2))
             for _ in range(40)}
    assert draws == {1, 3}


def test_sample_token_tiny_top_p_is_greedy():
    g = torch.Generator().manual_seed(0)
    for _ in range(10):
        assert int(sample_token(LOGITS, g, temperature=1.0,
                                top_p=0.01)) == 1


# ---------------------------------------------------------------------------
# BatchedServer
# ---------------------------------------------------------------------------
def _requests(cls, vocab):
    rng = np.random.default_rng(0)
    return [cls(rid=i, prompt=rng.integers(0, vocab, size=n),
                max_new_tokens=m)
            for i, (n, m) in enumerate([(5, 4), (3, 6), (7, 3), (4, 5)])]


def test_batched_server_greedy_tokens_match_reference():
    """Four greedy requests through two slots (recycled), f32 config."""
    kw = dict(num_layers=2, vocab_size=64, dtype="float32")
    rcfg = ref_get_config("smollm-360m").reduced(**kw)
    cfg = get_config("smollm-360m").reduced(**kw)
    rp = RT.init_params(jax.random.PRNGKey(3), rcfg)
    pp = T.from_reference(jax.tree.map(np.asarray, rp))
    ref = RefServer(rp, rcfg, max_batch=2, max_len=64)
    port = BatchedServer(pp, cfg, max_batch=2, max_len=64, device="cpu")
    for srv, cls in ((ref, RefRequest), (port, Request)):
        for r in _requests(cls, 64):
            srv.submit(r)
    rdone = {r.rid: r.out_tokens for r in ref.run_until_drained()}
    pdone = port.run_until_drained()
    assert sorted(r.rid for r in pdone) == [0, 1, 2, 3]
    assert all(r.done_s is not None and r.first_token_s is not None
               for r in pdone)
    for r in pdone:
        assert r.out_tokens == rdone[r.rid]
        assert len(r.out_tokens) == r.max_new_tokens
    assert port.run_until_drained() == []
    # every prompt token replayed, then one tick per later token
    assert port.decode_steps == sum(len(r.prompt) for r in pdone) + ticks(
        pdone, 2)
    assert ops.launch_counts()["decode_attention"] == 0


def ticks(reqs, max_batch):
    """Decode ticks of the reference's lockstep schedule for ``reqs`` in
    submission order through ``max_batch`` slots."""
    queue = sorted(reqs, key=lambda r: r.rid)
    slots = [None] * max_batch
    n = 0
    while queue or any(slots):
        for s in range(max_batch):
            if slots[s] is None and queue:
                slots[s] = [queue.pop(0).max_new_tokens, 1]
        if not any(slots):
            break
        n += 1
        for s in range(max_batch):
            if slots[s] is not None:
                slots[s][1] += 1
                if slots[s][1] >= slots[s][0]:
                    slots[s] = None
    return n


def test_batched_server_kv_reservation_returns_to_zero():
    cfg = get_config("smollm-360m").reduced(num_layers=2, vocab_size=64)
    params = T.init_params(cfg, torch.Generator().manual_seed(3))
    budget = MemoryBudget(None)
    srv = BatchedServer(params, cfg, max_batch=2, max_len=32, budget=budget,
                        device="cpu")
    assert budget.used() == srv.kv_bytes == 2 * 2 * 2 * 32 * 2 * 64 * 2
    srv.submit(Request(rid=0, prompt=np.arange(4), max_new_tokens=3))
    assert [r.rid for r in srv.run_until_drained()] == [0]
    srv.close()
    srv.close()
    assert budget.used() == 0


def test_batched_server_requires_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    cfg = get_config("smollm-360m").reduced(num_layers=2, vocab_size=64)
    with pytest.raises(RuntimeError):
        BatchedServer({}, cfg)
    with pytest.raises(RuntimeError):
        ColdServer("unused-root-never-created")


# ---------------------------------------------------------------------------
# ColdServer (tests/test_cold_server.py's cases)
# ---------------------------------------------------------------------------
def _synthetic(srv, name, layers, x):
    eng = srv.add_model(name, layers)
    eng.profiler_factory = SyntheticProfiler
    srv.decide(name, x, n_little=2, calibrate_interference=False)
    return eng


@pytest.fixture(scope="module")
def two_model_server(tmp_path_factory):
    srv = ColdServer(tmp_path_factory.mktemp("srv"), n_little=2,
                     max_concurrent_preps=1, device="cpu")
    inputs = {}
    for name, arch in (("mnet", "mobilenet"), ("snet", "squeezenet")):
        layers, x = build_cnn(arch, image=16, width=0.25)
        _synthetic(srv, name, layers, x)
        inputs[name] = x
    return srv, inputs


def test_two_models_cold_start_concurrently_no_crosstalk(two_model_server):
    srv, inputs = two_model_server
    isolated = {n: srv.cold_start(n, x).result() for n, x in inputs.items()}
    results = {}

    def go(name):
        results[name] = srv.cold_start(name, inputs[name]).result()

    ts = [threading.Thread(target=go, args=(n,)) for n in inputs]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    for name in inputs:
        assert torch.equal(results[name].output, isolated[name].output)
        # traces cover exactly this model's layers — no cross-talk
        assert {t.layer for t in results[name].traces} == \
            {t.layer for t in isolated[name].traces}
        assert set(results[name].weights) == \
            {l.spec.name for l in srv.engines[name].layers}
        # the resident weights serve a warm run with the same output
        warm = srv.warm_run(name, inputs[name])
        torch.testing.assert_close(warm.output, isolated[name].output,
                                   rtol=0, atol=0)
    assert srv.stats["max_active_preps"] <= 1


def test_admission_blocks_second_prep(two_model_server):
    """With cap=1, the second cold start must not enter its prep phase
    while the first is still prepping."""
    srv, inputs = two_model_server
    order = []

    def go(name):
        t = srv.cold_start(name, inputs[name])
        order.append(("admitted", name))
        t.result()

    ts = [threading.Thread(target=go, args=(n,)) for n in inputs]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert srv.stats["max_active_preps"] <= 1
    assert len(order) == 2


def test_lru_eviction_under_memory_budget(tmp_path):
    srv = ColdServer(tmp_path, n_little=2, max_concurrent_preps=2,
                     device="cpu")
    for name, arch in (("m1", "mobilenet"), ("m2", "squeezenet")):
        layers, x = build_cnn(arch, image=16, width=0.25)
        _synthetic(srv, name, layers, x)
        srv.cold_start(name, x).result()
        if name == "m1":
            # budget just under both models: the second arrival must evict
            srv.memory_budget_bytes = srv.resident_bytes() + 1
    assert srv.resident_models() == ["m2"]
    assert srv.stats["evictions"] == 1
    assert srv.budget.used() == srv.resident_bytes()
    # evicted model serves cold again; resident model serves warm
    _, x1 = build_cnn("mobilenet", image=16, width=0.25)
    assert srv.warm_run("m1", x1) is None
    r = srv.run("m1", x1)
    assert r.output is not None


def test_shared_profile_db_second_model_zero_profile_calls(tmp_path):
    srv = ColdServer(tmp_path, n_little=2, device="cpu")
    g1, toks = LG.tiny_llm_graph(4, seed=0)
    g2, _ = LG.tiny_llm_graph(4, seed=1)  # same shapes, different weights
    for name, g in (("m1", g1), ("m2", g2)):
        srv.add_model(name, g).profiler_factory = SyntheticProfiler
    s1 = srv.decide("m1", toks, n_little=2, calibrate_interference=False)
    s2 = srv.decide("m2", toks, n_little=2, calibrate_interference=False)
    assert s1["profile_calls"] > 0
    assert s2["profile_calls"] == 0
    assert s2["profile_db_hits"] > 0
    assert srv.engines["m1"].profile_db is srv.engines["m2"].profile_db
    assert srv.profile_db.path.parent == srv.root


# ---------------------------------------------------------------------------
# cold_start_llm
# ---------------------------------------------------------------------------
def test_cold_llm_first_token_before_last_layer_prep(tmp_path, monkeypatch):
    cfg = get_config("smollm-360m").reduced(**TINY)
    graph, toks = LG.tiny_llm_graph(4)
    srv = ColdServer(tmp_path, n_little=2, device="cpu")
    eng = _synthetic(srv, "llm", graph, toks)
    # The tiny blocks read in microseconds, so on a loaded host every prep
    # can end before the exec chain is first scheduled. Give the last
    # block the read time of a slow disk (0.3 s): its prep then overlaps
    # the exec chain, which is what execute-as-you-load is for.
    last = graph[-2].spec.name
    assert last.startswith("block")
    for meth in ("_read_op", "_read_op_async"):
        orig = getattr(PipelineRuntime, meth)

        def slow(self, *args, _orig=orig):
            w = _orig(self, *args)
            if args[-1] == last:
                time.sleep(0.3)
            return w
        monkeypatch.setattr(PipelineRuntime, meth, slow)
    res = PB.cold_start_llm(eng, cfg, toks[0], max_new_tokens=3, n_little=2,
                            server=srv, model_name="llm")
    assert res.first_token_before_last_prep
    assert res.first_token_s < res.decode_prep_s <= res.decode_ready_s
    assert res.overlapped_layers >= 1
    assert len(res.tokens) == 3
    assert all(0 <= t < cfg.vocab_size for t in res.tokens)
    assert res.tokens[0] == res.first_token
    # prompt + first token replayed, then one tick per later token
    assert res.decode_steps == toks.shape[1] + 1 + 1
    # decode_s times the ticks after the first one: none are left here
    assert res.decode_ticks == len(res.tokens) - 3 == 0
    # one pack per weighted layer, and the KV reservation came back
    assert sum(t.kind == "pack" for t in res.run.traces) == len(graph)
    assert srv.budget.used() == srv.resident_bytes()


def _pair(tmp_path, lossy=False):
    """The same tiny graph in both packages (reference params carried
    over), decided under SyntheticProfiler."""
    rcfg = ref_get_config("smollm-360m").reduced(**TINY)
    cfg = get_config("smollm-360m").reduced(**TINY)
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    pp = T.from_reference(jax.tree.map(np.asarray, rp))
    rg, rx = ref_build(rcfg, rp)
    pg, px = LG.build_llm_graph(cfg, pp)
    ref = RefEngine(rg, tmp_path / "ref", allow_lossy=lossy)
    ref.profiler_factory = RefSynthetic
    port = ColdEngine(pg, tmp_path / "port", allow_lossy=lossy, device="cpu")
    port.profiler_factory = SyntheticProfiler
    ref.decide(rx, n_little=2, calibrate_interference=False)
    port.decide(px, n_little=2, calibrate_interference=False)
    assert [(c.kernel, c.use_cache) for c in port.plan.choices] == \
        [(c.kernel, c.use_cache) for c in ref.plan.choices]
    return rcfg, cfg, ref, port, rx


def test_cold_llm_tokens_match_reference(tmp_path):
    rcfg, cfg, ref, port, x = _pair(tmp_path)
    want = RB.cold_start_llm(ref, rcfg, x[0], max_new_tokens=4, n_little=2)
    got = PB.cold_start_llm(port, cfg, x[0], max_new_tokens=4, n_little=2)
    assert got.first_token == want.first_token
    assert got.tokens == want.tokens
    assert got.decode_ticks == len(got.tokens) - 3 == 1


@pytest.mark.parametrize("kernel", ["int8", "int4"])
def test_cold_llm_packed_params_match_reference(tmp_path, monkeypatch,
                                                kernel):
    """Under a plan with every tblock and the head on the quantized
    kernel, the packs dequantize on the device; the stacked decode params
    equal the reference's host dequantization (f32, then bf16)."""
    rcfg, cfg, ref, port, x = _pair(tmp_path, lossy=True)
    pinned = [Choice("bf16_cast" if l.spec.op_type == "embed" else kernel,
                     False) for l in port.layers]
    port.set_plan(replace(port.plan, choices=pinned))
    seen = {}
    pack = PB._pack_params

    def spy(cfg_, packed):
        seen["params"] = pack(cfg_, packed)
        return seen["params"]

    monkeypatch.setattr(PB, "_pack_params", spy)
    ops.reset_launch_counts()
    res = PB.cold_start_llm(port, cfg, x[0], max_new_tokens=3, n_little=2)
    assert len(res.tokens) == 3
    blocks = seen["params"]["blocks"]
    kern = RefTBlockInt8() if kernel == "int8" else RefTBlockInt4()
    for i, rl in enumerate(ref.layers[1:-1]):
        entry = kern.transform(ref.store.read_raw(rl.spec.name), rl.spec)
        want = {k: np.asarray(jnp.asarray(v, jnp.bfloat16))
                for k, v in RB._expand_quantized(
                    entry, rl.spec.weight_shapes).items()}
        got = {**blocks["attn"], **blocks["mlp"],
               "ln1": blocks["ln1"], "ln2": blocks["ln2"]}
        assert sorted(want) == sorted(got)
        for k, w in want.items():
            g = got[k][i]
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(bf16.to_numpy(g).view(np.uint16),
                                          w.view(np.uint16))
    # the kernels' plain versions ran (CPU tensors): nothing launched
    assert all(n == 0 for n in ops.launch_counts().values())
