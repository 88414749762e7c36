"""``BatchedServer`` and the serve launcher on the moe, ssm and hybrid
families (reduced granite-moe-3b-a800m, mamba2-2.7b and zamba2-2.7b, the
last at 4 layers: two groups, each with its own application of the shared
block), against the JAX package's, on the CPU.

* Greedy tokens equal to the reference ``BatchedServer``'s for the same
  requests through two recycled slots, on f32 configs with the reference's
  params (``transformer.from_reference``): the same greedy argmax at the
  1e-4 logits agreement of ``test_torch_moe``/``test_torch_ssm``.
* ``kv_bytes``, the bytes of the decode state (KV caches for moe, conv and
  SSM states for ssm, both for hybrid), equal to the reference server's.
* Both servers refuse an ``embeddings`` and a ``vlm`` model
  (musicgen-medium, internvl2-76b), as the reference does.
* ``repro_torch.launch.serve.main`` serves both on the CPU when asked
  (``--device cpu``) and needs a card otherwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.serving import BatchedServer as RefServer  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import BatchedServer, Request  # noqa: E402

torch.set_num_threads(1)
ARCHS = ["granite-moe-3b-a800m", "mamba2-2.7b", "zamba2-2.7b"]


def _requests(cls, vocab):
    rng = np.random.default_rng(0)
    return [cls(rid=i, prompt=rng.integers(0, vocab, size=n),
                max_new_tokens=m)
            for i, (n, m) in enumerate([(5, 4), (3, 6), (7, 3), (4, 5)])]


def _pair(arch, **over):
    kw = {"num_layers": 4 if arch == "zamba2-2.7b" else 2, "vocab_size": 64,
          "dtype": "float32", **over}
    rcfg = ref_get_config(arch).reduced(**kw)
    cfg = get_config(arch).reduced(**kw)
    rp = RT.init_params(jax.random.PRNGKey(3), rcfg)
    return rcfg, cfg, rp, T.from_reference(jax.tree.map(np.asarray, rp))


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_server_greedy_tokens_match_reference(arch):
    """Four greedy requests through two slots (recycled), f32 config."""
    rcfg, cfg, rp, pp = _pair(arch)
    ref = RefServer(rp, rcfg, max_batch=2, max_len=64)
    port = BatchedServer(pp, cfg, max_batch=2, max_len=64, device="cpu")
    for srv, cls in ((ref, RefRequest), (port, Request)):
        for r in _requests(cls, 64):
            srv.submit(r)
    before = ops.launch_counts()
    rdone = {r.rid: r.out_tokens for r in ref.run_until_drained()}
    pdone = port.run_until_drained()
    assert sorted(r.rid for r in pdone) == [0, 1, 2, 3]
    for r in pdone:
        assert r.out_tokens == rdone[r.rid]
        assert len(r.out_tokens) == r.max_new_tokens
    assert ops.launch_counts() == before   # the CPU runs the plain versions


@pytest.mark.parametrize("arch", ARCHS)
def test_kv_bytes_match_reference(arch):
    rcfg, cfg, rp, pp = _pair(arch, dtype="bfloat16")
    port = BatchedServer(pp, cfg, max_batch=3, max_len=40, device="cpu")
    ref = RefServer(rp, rcfg, max_batch=3, max_len=40)
    assert port.kv_bytes == ref.kv_bytes
    assert port.kv_bytes == sum(t.nbytes for t in port.state.values())
    if cfg.family == "ssm":   # states, not caches: no max_len in them
        assert sorted(port.state) == ["conv_B", "conv_C", "conv_x", "ssm"]
        assert BatchedServer(pp, cfg, max_batch=3, max_len=400,
                             device="cpu").kv_bytes == port.kv_bytes


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_on_the_cpu(arch, capsys):
    reqs = serve.main(["--arch", arch, "--requests", "3", "--prompt-len",
                       "4", "--new-tokens", "3", "--max-batch", "2",
                       "--device", "cpu"])
    assert [len(r.out_tokens) for r in reqs] == [3, 3, 3]
    assert all(r.done_s is not None for r in reqs)
    out = capsys.readouterr().out
    assert f"arch={arch}-reduced" in out and "device=cpu" in out


@pytest.mark.parametrize("arch", ["musicgen-medium", "internvl2-76b"])
def test_batched_server_refuses_non_token_models(arch):
    """The server demo serves token models only, in both packages; so does
    the launcher."""
    rcfg, cfg, rp, pp = _pair(arch)
    with pytest.raises(AssertionError):
        RefServer(rp, rcfg, max_batch=2, max_len=16)
    with pytest.raises(AssertionError):
        BatchedServer(pp, cfg, max_batch=2, max_len=16, device="cpu")
    with pytest.raises(SystemExit):
        serve.main(["--arch", arch, "--device", "cpu"])


def test_serve_launcher_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the launcher would start")
    with pytest.raises(RuntimeError):
        serve.main(["--arch", "mamba2-2.7b", "--requests", "1"])
