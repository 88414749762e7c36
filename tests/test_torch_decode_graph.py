"""The decode step with its position on the device, and ``BatchedServer``'s
step as one CUDA graph, on the CPU at small size.

* ``decode_step`` with a 0-d tensor ``pos`` is bitwise ``decode_step``
  with an int ``pos``, in the logits and every state leaf: dense, moe,
  ssm, hybrid, gemma2's local/global pairs (an 8-entry ring that wraps),
  the int8 KV cache and a window-8 ring over 20 positions, in f32 and
  bf16.
* The tensor-``pos`` step against the reference's jitted ``decode_step``
  (its ``pos`` traced), at ``test_torch_decode.py``'s tolerances: 1e-4 in
  f32 (1e-2 with the int8 cache), 0.08 in bf16.
* A CPU ``BatchedServer``, which runs the body a card captures on its
  static buffers, gives the reference's greedy tokens with slots
  recycled, in each family.
* With a stand-in graph (its capture runs the body eagerly, its replay
  runs nothing): the warm-up and the capture leave the state bitwise as
  it was, and the launch counters after the run read as the eager run's
  (each replay adds the capture's counts, the capture's own are taken
  back).
* The dry run's ``serve_step`` (an int ``pos``) counts on meta what it
  counted before the position could be a tensor (frozen below for
  smollm-360m and zamba2-2.7b at ``decode_32k``); the same step with a
  tensor ``pos`` counts its ring writes as ``index_copy_`` scatters of
  the same updates plus their 8-byte indices.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.runtime_flags import FLAGS as REF_FLAGS  # noqa: E402
from repro.serving import BatchedServer as RefServer  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import attention as KA  # noqa: E402
from repro_torch.kernels import gmm as KG  # noqa: E402
from repro_torch.kernels import matmul as KM  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.runtime_flags import FLAGS  # noqa: E402
from repro_torch.roofline.op_cost import OpCounter  # noqa: E402
from repro_torch.serving import BatchedServer, Request  # noqa: E402
from repro_torch.serving import server as S  # noqa: E402

torch.set_num_threads(1)

# name: (arch, overrides beside the reduced config's, sliding window,
# positions, int8 KV cache)
CASES = {
    "dense": ("smollm-360m", {}, None, 12, False),
    "moe": ("granite-moe-3b-a800m", {}, None, 12, False),
    "ssm": ("mamba2-2.7b", {}, None, 12, False),
    "hybrid": ("zamba2-2.7b", {"num_layers": 4}, None, 12, False),
    # the local layers' 8-entry ring wraps within the 12 positions
    "local_global": ("gemma2-27b", {"sliding_window": 8}, None, 12, False),
    "int8_kv": ("qwen3-32b", {}, None, 12, True),
    "window8_ring": ("smollm-360m", {}, 8, 20, False),
}


@pytest.fixture
def kv_flag(request):
    """``kv_cache_int8`` as the case asks, in both packages, restored
    afterwards."""
    saved = dict(REF_FLAGS), dict(FLAGS)
    REF_FLAGS["kv_cache_int8"] = FLAGS["kv_cache_int8"] = CASES[
        request.param][4]
    yield request.param
    for flags, old in zip((REF_FLAGS, FLAGS), saved):
        flags.clear()
        flags.update(old)


def _cfgs(name, dtype="float32", **extra):
    arch, over, win, _, _ = CASES[name]
    kw = {"dtype": dtype, **over, **extra}
    rcfg, cfg = ref_get_config(arch).reduced(**kw), get_config(arch).reduced(
        **kw)
    if win:
        rcfg, cfg = rcfg.with_sliding_window(win), cfg.with_sliding_window(win)
    return rcfg, cfg


def _params(rcfg):
    rp = RT.init_params(jax.random.PRNGKey(1), rcfg)
    return rp, T.from_reference(jax.tree.map(np.asarray, rp))


def _tokens(cfg, S, B=2):
    return np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _decode_run(pp, cfg, toks, tensor_pos):
    B, S = toks.shape
    state = T.init_decode_state(cfg, B, S, device="cpu")
    out = []
    for t in range(S):
        pos = torch.tensor(t) if tensor_pos else t
        lg, state = T.decode_step(
            pp, state, {"tokens": torch.from_numpy(toks[:, t:t + 1])}, pos,
            cfg)
        out.append(lg.clone())
    return out, state


# ---------------------------------------------------------------------------
# the position on the device
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_flag", sorted(CASES), indirect=True)
def test_tensor_pos_is_int_pos_bitwise(kv_flag, dtype):
    rcfg, cfg = _cfgs(kv_flag, dtype)
    _, pp = _params(rcfg)
    toks = _tokens(cfg, CASES[kv_flag][3])
    want, wstate = _decode_run(pp, cfg, toks, tensor_pos=False)
    got, gstate = _decode_run(pp, cfg, toks, tensor_pos=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert list(gstate) == list(wstate)
    for k in wstate:
        assert gstate[k].dtype == wstate[k].dtype
        assert torch.equal(gstate[k], wstate[k]), k


@pytest.mark.parametrize("kv_flag,dtype", [
    *[(c, "float32") for c in sorted(CASES)],
    ("dense", "bfloat16"), ("local_global", "bfloat16"),
    ("int8_kv", "bfloat16")], indirect=["kv_flag"])
def test_tensor_pos_step_matches_reference(kv_flag, dtype):
    rcfg, cfg = _cfgs(kv_flag, dtype)
    rp, pp = _params(rcfg)
    toks = _tokens(cfg, CASES[kv_flag][3])
    B, S = toks.shape
    rstate = RT.init_decode_state(rcfg, B, S)
    state = T.init_decode_state(cfg, B, S, device="cpu")
    rstep = jax.jit(lambda p, s, b, pos: RT.decode_step(p, s, b, pos, rcfg))
    tol = (0.08 if dtype == "bfloat16" else 1e-2 if CASES[kv_flag][4]
           else 1e-4)
    for t in range(S):
        rl, rstate = rstep(rp, rstate,
                           {"tokens": jnp.asarray(toks[:, t:t + 1])},
                           jnp.int32(t))
        lg, state = T.decode_step(
            pp, state, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
            torch.tensor(t), cfg)
        np.testing.assert_allclose(lg.numpy(), np.asarray(rl), atol=tol,
                                   rtol=tol)


# ---------------------------------------------------------------------------
# BatchedServer through its static buffers
# ---------------------------------------------------------------------------
def _requests(cls, vocab):
    rng = np.random.default_rng(0)
    return [cls(rid=i, prompt=rng.integers(0, vocab, size=n),
                max_new_tokens=m)
            for i, (n, m) in enumerate([(5, 4), (3, 6), (7, 3), (4, 5)])]


@pytest.mark.parametrize("kv_flag", ["dense", "moe", "ssm", "hybrid",
                                     "local_global"], indirect=True)
def test_cpu_server_greedy_tokens_match_reference(kv_flag):
    """Four greedy requests through two slots (recycled), f32; gemma2's
    8-entry local ring wraps."""
    rcfg, cfg = _cfgs(kv_flag, vocab_size=64)
    rp, pp = _params(rcfg)
    ref = RefServer(rp, rcfg, max_batch=2, max_len=64)
    port = BatchedServer(pp, cfg, max_batch=2, max_len=64, device="cpu")
    assert not port.graphed          # no graphs on the CPU
    for srv, cls in ((ref, RefRequest), (port, Request)):
        for r in _requests(cls, 64):
            srv.submit(r)
    want = {r.rid: r.out_tokens for r in ref.run_until_drained()}
    got = {r.rid: r.out_tokens for r in port.run_until_drained()}
    assert got == want and sorted(got) == [0, 1, 2, 3]
    assert port.captures == 0 and int(port.pos.max()) > 8


class StandInGraph:
    """A CUDA graph's stand-in on the CPU: its capture runs the body
    eagerly, its replay runs nothing."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def stand_in(monkeypatch):
    graphs = []

    def new_graph():
        graphs.append(StandInGraph())
        return graphs[-1]

    monkeypatch.setattr(S, "_new_graph", new_graph)
    monkeypatch.setattr(S, "_capturing",
                        lambda graph, stream: contextlib.nullcontext())
    return graphs


@pytest.mark.parametrize("kv_flag", ["dense", "ssm", "hybrid", "int8_kv"],
                         indirect=True)
def test_capture_leaves_the_state_bitwise(kv_flag, stand_in):
    _, cfg = _cfgs(kv_flag, "bfloat16")
    pp = T.init_params(cfg, torch.Generator().manual_seed(0))
    srv = BatchedServer(pp, cfg, max_batch=2, max_len=32, device="cpu")
    srv.submit(Request(rid=0, prompt=np.arange(5), max_new_tokens=8))
    for _ in range(3):              # eager ticks fill the state
        srv.step()
    before = {k: t.clone() for k, t in srv.state.items()}
    assert any(t.any() for t in before.values())
    srv.graphed = True
    tok = np.full((2, 1), 3, np.int64)
    logits = srv._decode(tok, int(srv.pos.max()))
    assert srv.captures == 1 and len(stand_in) == 1
    assert stand_in[0].replays == 1 and logits is srv._logits
    for k, t in srv.state.items():
        assert torch.equal(t, before[k]), k
    srv._decode(tok, int(srv.pos.max()) + 1)   # a replay: no capture
    assert srv.captures == 1 and stand_in[0].replays == 2


@pytest.fixture
def counting(monkeypatch):
    """The CPU wrappers counting a launch (and a bf16 GEMM path) where the
    card's would."""
    def wrap(name, counter, key):
        fn = getattr(ops, name)

        def wrapped(*a, **kw):
            k = key(*a) if callable(key) else key
            counter[k] += 1
            if k == "matmul_bf16":
                KM.gemm_paths["tile"] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(ops, name, wrapped)

    wrap("matmul", KM.launches,
         lambda x, w: "matmul_bf16" if x.dtype == torch.bfloat16
         else "matmul")
    wrap("decode_attention", KA.launches, "decode_attention")
    wrap("gmm_blocks", KG.launches, "gmm_blocks")
    yield
    ops.reset_launch_counts()


@pytest.mark.parametrize("kv_flag", ["dense", "moe", "hybrid"],
                         indirect=True)
def test_replays_count_the_eager_launches(kv_flag, counting, stand_in):
    _, cfg = _cfgs(kv_flag, "bfloat16", vocab_size=64)
    pp = T.init_params(cfg, torch.Generator().manual_seed(0))
    runs = []
    for graphed in (False, True):
        srv = BatchedServer(pp, cfg, max_batch=2, max_len=64, device="cpu")
        srv.graphed = graphed
        for r in _requests(Request, 64):
            srv.submit(r)
        ops.reset_launch_counts()
        srv.run_until_drained()
        runs.append((srv, ops.launch_counts(), ops.gemm_path_counts()))
    (eager, counts, paths), (graphed, gcounts, gpaths) = runs
    assert counts["decode_attention"] > 0 and paths["tile"] > 0
    assert gcounts == counts and gpaths == paths
    assert graphed.decode_steps == eager.decode_steps
    assert graphed.captures == 1 and stand_in[0].replays == \
        graphed.decode_steps
    # one step's launches a replay
    step = {k: n for k, n in graphed._replay_counts[0].items()}
    assert {k: n * graphed.decode_steps for k, n in step.items()} == {
        k: n for k, n in counts.items() if n}


# ---------------------------------------------------------------------------
# the roofline count of a decode step
# ---------------------------------------------------------------------------
# the dry run's decode_32k serve_step on meta, counted before the position
# could be a tensor: flops, HBM bytes, transcendentals, ops, peak bytes
SERVE_STEP = {
    "smollm-360m": (608108536064.0, 173477818752.0, 19007616.0, 2028,
                    172560574848.0),
    "zamba2-2.7b": (1212368846256.0, 492268270720.0, 144081712.0, 4575,
                    401018182080.0),
}


@pytest.mark.parametrize("arch", sorted(SERVE_STEP))
def test_serve_step_count_unchanged(arch):
    step = dryrun.build_step(arch, "decode_32k", device="meta")
    _, cost, _, _, _ = dryrun.count_step(step)
    assert (cost.flops, cost.hbm_bytes, cost.transcendentals, cost.ops,
            cost.peak_bytes) == SERVE_STEP[arch]
    # the same step with its position a meta tensor: each ring write is an
    # index_copy_ of the same update, plus its int64 index
    params, state, batch, pos = step.args
    with torch.no_grad(), OpCounter() as c:
        c.track(step.args)
        step.fn(params, state, batch, torch.tensor(pos, device="meta"))
    cfg = step.cfg
    writes = 2 * (cfg.num_layers // cfg.shared_attn_every
                  if cfg.family == "hybrid" else cfg.num_layers)
    int_b = cost.hbm_contrib["copy_ bfloat16"]
    got_b = (c.cost.hbm_contrib.get("copy_ bfloat16", 0.0)
             + c.cost.hbm_contrib["index_copy_ bfloat16"])
    assert got_b == int_b + 8 * writes
    kernels = {k: v for k, v in cost.kernels.items()}
    assert c.cost.kernels == kernels and kernels
    assert abs(c.cost.flops - cost.flops) <= 1e-8 * cost.flops
