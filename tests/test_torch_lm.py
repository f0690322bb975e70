"""The port's LM serving slice against the JAX package, on the CPU.

Reduced configs (``reduced()``: d 64, 4 heads, 2 kv heads, dh 16, vocab
256), S <= 32, fp32 on both sides: the JAX side runs under
``jax.enable_x64(False)`` (other test modules turn x64 on at import), the
weights are the JAX package's, carried across by ``repro_torch.convert``,
and the tokens come from a numpy seed.  Under ``attn_impl="pallas"`` the
JAX side runs its Pallas kernel in interpret mode and the port's wrapper
serves ``attention_plain`` for the CPU tensors.

RWKV6 (``rwkv6-7b``, reduced to 2 layers) runs its sequential scan at
S <= 256 and its chunked form above (S 300 here): the JAX side its jnp
``chunk_step`` scan, the port its kernel's plain version.

Tolerances: LM_TOL (rtol = atol = 2e-5) for logits, losses and decode
states in fp32 (the two frameworks sum the same products in another
order; the measured differences are below 4e-6, and below 1e-5 of
1 + |x| where the chunked RWKV6 form runs, whose cumsum and exponentials
the two frameworks round differently); tokens are held equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs.base import reduced as j_reduced
from repro.configs.registry import ARCHS as J_ARCHS
from repro.configs.registry import get_arch as j_get_arch
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.launch import serve as j_serve
from repro.models import lm as jlm
from repro.nn import attention as jattn
from repro.nn import layers as jlayers
from repro.nn import transformer as jtf
from repro.serve import LMEngine as JLMEngine
from repro_torch import convert
from repro_torch.configs.base import SHAPES, ShapeCell, reduced
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch import serve as t_serve
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import lm as tlm
from repro_torch.nn import attention as tattn
from repro_torch.nn import layers as tlayers
from repro_torch.nn import transformer as ttf
from repro_torch.serve import AdmissionError, BucketSpec, LMEngine, RequestQueue

LM_TOL = dict(rtol=2e-5, atol=2e-5)
ARCHS_SLICE = ["tinyllama-1.1b", "smollm-135m", "gemma3-4b"]
# (arch, prompt length): the attention archs at S 24; RWKV6 on both sides
# of its 256-token switch
# the MoE archs at S 24: reduced Mixtral (4 experts, top 2, window 8) and
# DBRX at its own 16 experts, top 4 (``_cfgs``); the hybrid RecurrentGemma
# at S 24 (r, r, a, r: an 'r' layer in the unrolled remainder)
LM_CASES = [pytest.param(a, 24, id=a) for a in ARCHS_SLICE] + [
    pytest.param("rwkv6-7b", 32, id="rwkv6-7b-scan"),
    pytest.param("rwkv6-7b", 300, id="rwkv6-7b-chunked"),
    pytest.param("mixtral-8x7b", 24, id="mixtral-8x7b"),
    pytest.param("dbrx-132b", 24, id="dbrx-132b"),
    pytest.param("recurrentgemma-9b", 24, id="recurrentgemma-9b")]


@pytest.fixture(autouse=True)
def _f32():
    with jax.enable_x64(False):
        yield


def _cfgs(arch, **kw):
    kw.setdefault("attn_impl", "pallas")
    if arch == "rwkv6-7b":
        kw.setdefault("n_layers", 2)
    if arch == "dbrx-132b":  # reduced() cuts it to 4 experts, top 2
        kw.update(n_experts=16, top_k=4)
    return (j_reduced(j_get_arch(arch), **kw), reduced(get_arch(arch), **kw))


def _params(jcfg, seed=0):
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    jp = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jp)
    return jp, convert.params_from_jax(jp, device="cpu")


def _tokens(b, s, vocab=256, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


def _close(j, t, tol=LM_TOL):
    np.testing.assert_allclose(np.asarray(t.detach().float()),
                               np.asarray(j, np.float32), **tol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_configs_are_the_jax_packages():
    assert set(ARCHS) == set(J_ARCHS)
    for name in ARCHS:
        assert dataclasses.asdict(ARCHS[name]) == \
            dataclasses.asdict(J_ARCHS[name])
        assert dataclasses.asdict(reduced(ARCHS[name])) == \
            dataclasses.asdict(j_reduced(J_ARCHS[name]))
        assert ARCHS[name].param_count() == J_ARCHS[name].param_count()
    assert set(SHAPES) == {"train_4k", "prefill_32k", "decode_32k",
                           "long_500k"}


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_stack_plan_and_windows_match_jax(arch):
    for cfg_j, cfg_t in [(J_ARCHS[arch], ARCHS[arch]),
                         (j_reduced(J_ARCHS[arch]), reduced(ARCHS[arch]))]:
        assert ttf.stack_plan(cfg_t) == jtf.stack_plan(cfg_j)
        rows, rem = ttf._unit_windows(cfg_t)
        w_scan, w_rem = jtf._unit_windows(cfg_j)
        w_scan = np.asarray(w_scan)
        assert np.array_equal(np.asarray(rows).reshape(w_scan.shape)
                              if w_scan.ndim == 2
                              else np.asarray(rows[0] if rows else ()),
                              w_scan)
        assert tuple(rem) == tuple(w_rem)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_jax(theta):
    rs = np.random.RandomState(0)
    x = rs.randn(2, 12, 4, 16).astype(np.float32)
    pos = np.stack([np.arange(12), np.arange(5, 17)]).astype(np.int32)
    j = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    t = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(j, t)
    # interleaved (even, odd) pairs: position 0 leaves x unchanged, and a
    # rotation keeps each pair's norm
    np.testing.assert_allclose(t[0, 0].numpy(), x[0, 0], rtol=0, atol=0)
    pair = lambda a: a[..., 0::2] ** 2 + a[..., 1::2] ** 2  # noqa: E731
    np.testing.assert_allclose(pair(t.numpy()), pair(x), rtol=1e-5,
                               atol=1e-5)


def test_rmsnorm_layernorm_glu_match_jax():
    rs = np.random.RandomState(1)
    x = rs.randn(3, 5, 64).astype(np.float32)
    scale = (1 + 0.1 * rs.randn(64)).astype(np.float32)
    bias = (0.1 * rs.randn(64)).astype(np.float32)
    _close(jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)),
           tlayers.rmsnorm({"scale": torch.from_numpy(scale)},
                           torch.from_numpy(x)))
    _close(jlayers.layernorm({"scale": jnp.asarray(scale),
                              "bias": jnp.asarray(bias)}, jnp.asarray(x)),
           tlayers.layernorm({"scale": torch.from_numpy(scale),
                              "bias": torch.from_numpy(bias)},
                             torch.from_numpy(x)))
    jp = jlayers.glu_mlp_init(jax.random.PRNGKey(0), 64, 96)
    tp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    for act in ("silu", "gelu"):
        _close(jlayers.glu_mlp(jp, jnp.asarray(x), act),
               tlayers.glu_mlp(tp, torch.from_numpy(x), act))


def test_init_draws_the_jax_layout_on_the_generators_device():
    jcfg, tcfg = _cfgs("tinyllama-1.1b")
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tlm.init_params(tcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    jshapes = jax.tree_util.tree_map(lambda a: (tuple(a.shape),
                                                str(a.dtype)), jp)
    tshapes = jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype)), convert.params_to_numpy(tp))
    assert jshapes == tshapes
    # the same seed gives the same weights; the scales follow the JAX init
    again = tlm.init_params(tcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    assert torch.equal(tp["embed"]["table"], again["embed"]["table"])
    wq = tp["blocks"]["scan"]["0_a"]["attn"]["wq"]
    assert abs(float(wq.std()) - 64 ** -0.5) < 0.02
    # full-width configs keep their dtype: bf16 parameters
    full = tlm.init_params(dataclasses.replace(
        get_arch("smollm-135m"), n_layers=1, d_model=64, d_ff=64, n_heads=1,
        n_kv_heads=1, vocab_size=8), torch.Generator().manual_seed(0),
        device="cpu")
    assert full["embed"]["table"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["naive", "chunked", "chunked_ad", "pallas",
                                  "auto"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 8),
                                           (False, 0)])
@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2)])
def test_attention_impls_match_jax(impl, causal, window, h, hkv):
    rs = np.random.RandomState(2)
    b, s, dh = 2, 24, 16
    q = rs.randn(b, s, h, dh).astype(np.float32)
    k = rs.randn(b, s, hkv, dh).astype(np.float32)
    v = rs.randn(b, s, hkv, dh).astype(np.float32)
    j = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, window=window, impl=impl)
    t = tattn.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=causal, window=window,
                        impl=impl)
    assert t.shape == (b, s, h, dh)
    _close(j, t)


@pytest.mark.parametrize("window", [0, 8])
def test_attention_chunked_blocks_and_window_skip(window):
    """Several query and key blocks, with the sliding-window block skip."""
    rs = np.random.RandomState(3)
    q = rs.randn(1, 40, 2, 16).astype(np.float32)
    k = rs.randn(1, 40, 2, 16).astype(np.float32)
    v = rs.randn(1, 40, 2, 16).astype(np.float32)
    ref = tattn.attention_naive(*map(torch.from_numpy, (q, k, v)),
                                window=window)
    out = tattn.attention_chunked(*map(torch.from_numpy, (q, k, v)),
                                  window=window, q_block=8, k_block=8)
    j = jattn.attention_chunked(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), window=window, q_block=8,
                                k_block=8)
    _close(j, out)
    torch.testing.assert_close(out, ref, **LM_TOL)


def test_attention_block_and_decode_block_match_jax():
    jp = jattn.init_attention(jax.random.PRNGKey(0), 64, 4, 2, 16)
    tp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    rs = np.random.RandomState(4)
    x = rs.randn(2, 10, 64).astype(np.float32)
    for window in (0, 4):
        _close(jattn.attention_block(jp, jnp.asarray(x), n_heads=4,
                                     rope_theta=1e4, window=window,
                                     impl="naive"),
               tattn.attention_block(tp, torch.from_numpy(x), n_heads=4,
                                     rope_theta=1e4, window=window,
                                     impl="naive"))
        ck = rs.randn(2, 16, 2, 16).astype(np.float32)
        cv = rs.randn(2, 16, 2, 16).astype(np.float32)
        xt = x[:, :1]
        jo, jk, jv = jattn.decode_attention_block(
            jp, jnp.asarray(xt), jnp.asarray(ck), jnp.asarray(cv),
            jnp.int32(9), n_heads=4, rope_theta=1e4, window=window)
        tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
        to, tk2, tv2 = tattn.decode_attention_block(
            tp, torch.from_numpy(xt), tk, tv, 9, n_heads=4, rope_theta=1e4,
            window=window)
        assert tk2 is tk and tv2 is tv  # updated in place
        _close(jo, to)
        _close(jk, tk)
        _close(jv, tv)


# ---------------------------------------------------------------------------
# the model: forward, loss, prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,s", LM_CASES)
def test_lm_forward_prefill_decode_match_jax(arch, s):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    b, max_seq = 2, s + 8
    toks = _tokens(b, s)
    batch_j = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(toks)}
    batch_t = {"tokens": torch.from_numpy(toks),
               "targets": torch.from_numpy(toks)}
    with torch.no_grad():
        jl, jaux = jlm.forward(jcfg, jp, batch_j)
        tl, aux = tlm.forward(tcfg, tp, batch_t)
        _close(jl, tl)
        if tcfg.n_experts:  # the summed load-balancing loss
            assert float(aux) > 0.0
            _close(jaux, aux)
        else:
            assert float(aux) == 0.0
        (jloss, jm), (tloss, tm) = (jlm.loss_fn(jcfg, jp, batch_j),
                                    tlm.loss_fn(tcfg, tp, batch_t))
        _close(jloss, tloss)
        _close(jm["ce"], tm["ce"])

        ops.reset_counts()
        jst, jlast = jlm.prefill(jcfg, jp, {"tokens": batch_j["tokens"]},
                                 max_seq)
        tst, tlast = tlm.prefill(tcfg, tp, {"tokens": batch_t["tokens"]},
                                 max_seq)
        # one plain kernel call per attention layer, and per RWKV6 layer
        # above 256 tokens (CPU tensors)
        assert (ops.flash_plain_calls, ops.flash_launches) == \
            (tlm.expected_flash_calls(tcfg, 1), 0)
        assert (ops.rwkv6_plain_calls, ops.rwkv6_launches) == \
            (tlm.expected_rwkv6_calls(tcfg, s, 1), 0)
        assert ops.flash_plain_calls + ops.rwkv6_plain_calls == \
            (0 if arch == "rwkv6-7b" and s <= 256
             else sum(k in "aw" for k in tcfg.kinds))
        _close(jlast, tlast)
        jst_np = jax.tree_util.tree_map(np.asarray, jst)
        tst_np = convert.params_to_numpy(tst)
        assert jax.tree_util.tree_structure(jst_np) == \
            jax.tree_util.tree_structure(tst_np)
        jax.tree_util.tree_map(
            lambda a, c: np.testing.assert_allclose(c, a, **LM_TOL),
            jst_np, tst_np)

        tok = np.asarray(jnp.argmax(jlast, -1))[:, None].astype(np.int32)
        for i in range(4):
            jlg, jst = jlm.decode_step(jcfg, jp, jst, jnp.asarray(tok),
                                       jnp.int32(s + i))
            tlg, tst = tlm.decode_step(tcfg, tp, tst, torch.from_numpy(tok),
                                       s + i)
            _close(jlg, tlg)
            assert np.array_equal(np.asarray(jnp.argmax(jlg, -1)),
                                  torch.argmax(tlg, -1).numpy())
            tok = np.asarray(jnp.argmax(jlg, -1))[:, None].astype(np.int32)
        jax.tree_util.tree_map(
            lambda a, c: np.testing.assert_allclose(c, a, **LM_TOL),
            jax.tree_util.tree_map(np.asarray, jst),
            convert.params_to_numpy(tst))


def test_rwkv6_prefill_then_decode_equals_forward():
    """The JAX package's teacher-forced contract (tests/test_archs.py:67):
    prefill on S-1 tokens + 1 decode step gives the forward's logits at
    the last position, rtol = atol = 2e-4; here at S 300, so the prefill
    takes the chunked form (the kernel's route) and the decode carries its
    state."""
    _, tcfg = _cfgs("rwkv6-7b")
    _, tp = _params(j_reduced(j_get_arch("rwkv6-7b"), n_layers=2), seed=1)
    toks = torch.from_numpy(_tokens(2, 300, seed=6))
    with torch.no_grad():
        full, _ = tlm.forward(tcfg, tp, {"tokens": toks})
        ops.reset_counts()
        state, _ = tlm.prefill(tcfg, tp, {"tokens": toks[:, :-1]}, 304)
        assert ops.rwkv6_plain_calls == tlm.expected_rwkv6_calls(
            tcfg, 299, 1) == 2
        dec, _ = tlm.decode_step(tcfg, tp, state, toks[:, -1:], 299)
    np.testing.assert_allclose(dec.numpy(), full[:, -1].numpy(), rtol=2e-4,
                               atol=2e-4)
    assert tlm.expected_rwkv6_calls(tcfg, 256, 3) == 0
    assert tlm.expected_rwkv6_calls(tcfg, 257, 3) == 6
    assert tlm.expected_rwkv6_calls(get_arch("rwkv6-7b"), 2048, 1) == 32
    assert tlm.expected_rwkv6_calls(get_arch("tinyllama-1.1b"), 2048, 1) == 0


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "dbrx-132b"])
def test_moe_prefill_then_decode_equals_dropless_forward(arch):
    """The JAX package's teacher-forced contract (tests/test_archs.py:67)
    for a dropless MoE: prefill on S-1 tokens (routed rows, ``"sorted"``)
    + 1 decode step (static slots) gives the forward's logits at the last
    position (the forward at cf = E, so nothing drops), rtol = atol =
    2e-4.  And the flash launches of Mixtral's prefill waves."""
    jcfg, tcfg = _cfgs(arch)
    _, tp = _params(jcfg, seed=1)
    toks = torch.from_numpy(_tokens(2, 20, seed=6))
    dropless = dataclasses.replace(tcfg,
                                   capacity_factor=float(tcfg.n_experts))
    with torch.no_grad():
        full, aux = tlm.forward(dropless, tp, {"tokens": toks})
        ops.reset_counts()
        state, _ = tlm.prefill(tcfg, tp, {"tokens": toks[:, :-1]}, 24)
        assert ops.flash_plain_calls == tlm.expected_flash_calls(tcfg, 1) \
            == tcfg.n_layers
        dec, _ = tlm.decode_step(tcfg, tp, state, toks[:, -1:], 19)
    np.testing.assert_allclose(dec.numpy(), full[:, -1].numpy(), rtol=2e-4,
                               atol=2e-4)
    mixtral8 = dataclasses.replace(get_arch("mixtral-8x7b"), n_layers=8,
                                   windows=(4096,) * 8, attn_impl="pallas")
    assert tlm.expected_flash_calls(mixtral8, 2) == 16


def test_prefill_impls_agree_and_steps_wrap_the_model():
    _, tcfg = _cfgs("gemma3-4b")
    _, tp = _params(j_reduced(j_get_arch("gemma3-4b")))
    toks = torch.from_numpy(_tokens(2, 20, seed=5))
    outs = {}
    with torch.no_grad():
        for impl in ("pallas", "naive", "chunked"):
            cfg = dataclasses.replace(tcfg, attn_impl=impl)
            state, last = make_prefill_step(cfg, 24)(tp, {"tokens": toks})
            logits, _ = make_decode_step(cfg)(tp, state,
                                              torch.argmax(last, -1)[:, None],
                                              20)
            outs[impl] = (last, logits)
    for impl in ("naive", "chunked"):
        for a, b in zip(outs[impl], outs["pallas"]):
            torch.testing.assert_close(a, b, **LM_TOL)
    assert tlm.expected_flash_calls(dataclasses.replace(tcfg,
                                                        attn_impl="naive"),
                                    3) == 0
    assert tlm.expected_flash_calls(tcfg, 3) == 3 * tcfg.n_layers
    assert tlm.expected_flash_calls(
        dataclasses.replace(get_arch("tinyllama-1.1b"), attn_impl="pallas"),
        1) == 22


@pytest.mark.parametrize("arch,what", [
    ("whisper-medium", "encoder-decoder"),
    ("llava-next-mistral-7b", "vision_stub")])
def test_unported_families_raise_naming_the_roadmap(arch, what):
    with pytest.raises(NotImplementedError, match="ROADMAP") as e:
        tlm.init_params(reduced(get_arch(arch)),
                        torch.Generator().manual_seed(0), device="cpu")
    assert what in str(e.value)


def test_rwkv6_initialises_on_the_cpu_in_the_jax_layout():
    jcfg, tcfg = _cfgs("rwkv6-7b")
    tp = tlm.init_params(tcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    shapes = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda a: (tuple(a.shape), str(a.dtype)), tree)
    assert shapes(convert.params_to_numpy(tp)) == \
        shapes(jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    assert shapes(convert.params_to_numpy(
        tlm.init_decode_state(tcfg, 2, 8, device="cpu"))) == \
        shapes(jlm.init_decode_state(jcfg, 2, 8))


# ---------------------------------------------------------------------------
# data, queue, engine, CLI
# ---------------------------------------------------------------------------

def test_synthetic_lm_is_deterministic_and_zipf_like():
    cfg = reduced(get_arch("smollm-135m"))
    pipe = SyntheticLM(cfg, ShapeCell("s", 512, 8, "prefill"), seed=3)
    a, b = pipe.batch(0), pipe.batch(0)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], pipe.batch(1)["tokens"])
    t = a["tokens"]
    assert t.shape == (8, 512) and t.dtype == torch.int32
    assert int(t.min()) >= 0 and int(t.max()) < cfg.vocab_size
    assert torch.equal(a["targets"], t)
    # the JAX rule's shape: P(rank < v/8) = P(u^3 < 1/8) = 1/2
    jt = np.asarray(JSyntheticLM(j_reduced(j_get_arch("smollm-135m")),
                                 ShapeCell("s", 512, 8, "prefill"),
                                 seed=3).batch(0)["tokens"])
    for toks in (t.numpy(), jt):
        assert abs(float((toks < cfg.vocab_size // 8).mean()) - 0.5) < 0.03


def test_queue_admission_and_aging():
    q = RequestQueue(kinds=("lm",), dim=4)
    with pytest.raises(AdmissionError, match="unknown kind"):
        q.submit("score", np.zeros(4))
    with pytest.raises(AdmissionError, match="shape"):
        q.submit("lm", np.zeros(5))
    with pytest.raises(AdmissionError, match="non-finite"):
        q.submit("lm", np.array([0.0, np.nan, 0.0, 0.0]))
    low = q.submit("lm", np.zeros(4), priority=0.0)
    for _ in range(3):
        q.next_batch(0)  # ticks pass, the waiting request ages
    q.submit("lm", np.ones(4), priority=2.5)
    (req, ticket), = q.next_batch(1)
    assert ticket is low and q.depth() == 1
    assert BucketSpec((4, 1, 2)).bucket_for(3) == 4
    assert BucketSpec((1, 2)).bucket_for(9) == 2


def _auto_mesh():
    # jax 0.9's default mesh has Explicit axes, which the JAX package's
    # attention sharding pins refuse; its LMEngine takes a mesh argument
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma3-4b", "rwkv6-7b",
                                  "mixtral-8x7b", "dbrx-132b",
                                  "recurrentgemma-9b"])
def test_lm_engine_tokens_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    prompts = _tokens(5, 16, seed=1)
    kw = dict(lanes=2, prompt_len=16, max_gen=6, decode_slice=4)
    je = JLMEngine(jcfg, params=jp, mesh=_auto_mesh(), **kw)
    te = LMEngine(tcfg, params=tp, device="cpu", **kw)
    gens = [6, 5, 6, 5, 1]
    jt = [je.submit(p, gen=g) for p, g in zip(prompts, gens)]
    tt = [te.submit(p, gen=g) for p, g in zip(prompts, gens)]
    je.run()
    te.run()
    for a, b, g in zip(jt, tt, gens):
        ra, rb = a.result(1.0), b.result(1.0)
        assert rb.shape == (g,) and rb.dtype == np.int32
        np.testing.assert_array_equal(rb, ra)
    keys = ("op", "tokens", "compile", "lanes")
    assert [tuple(c[k] for k in keys) for c in te.call_log] == \
        [tuple(c[k] for k in keys) for c in je.call_log]


def test_lm_engine_temperature_sampling_is_seeded():
    _, tcfg = _cfgs("smollm-135m")
    prompts = _tokens(2, 8, seed=2)

    def run(seed):
        eng = LMEngine(tcfg, lanes=2, prompt_len=8, max_gen=5,
                       temperature=1.0, seed=seed, device="cpu")
        ts = [eng.submit(p) for p in prompts]
        eng.run()
        return np.stack([t.result(1.0) for t in ts])

    a = run(0)
    assert np.array_equal(a, run(0))
    assert a.shape == (2, 5) and a.min() >= 0 and a.max() < tcfg.vocab_size


def test_stats_from_log_matches_jax():
    log = [{"op": "prefill", "wall_s": 0.5, "tokens": 4, "compile": True},
           {"op": "decode", "wall_s": 0.3, "tokens": 16, "compile": True},
           {"op": "decode", "wall_s": 0.1, "tokens": 16, "compile": False},
           {"op": "prefill", "wall_s": 0.2, "tokens": 4, "compile": False},
           {"op": "decode", "wall_s": 0.1, "tokens": 8, "compile": False}]
    assert t_serve._stats_from_log(log, 48) == \
        j_serve._stats_from_log(log, 48)


def test_serve_cli_runs_on_cpu_and_needs_a_card_otherwise(monkeypatch,
                                                          capsys, tmp_path):
    metrics = tmp_path / "serve.jsonl"
    t_serve.main(["--device", "cpu", "--arch", "smollm-135m", "--batch", "2",
                  "--prompt-len", "16", "--gen", "4", "--metrics",
                  str(metrics)])
    out = capsys.readouterr().out
    assert "[serve] generated (2, 4) tokens" in out
    from repro_torch.obs import read_jsonl
    (rec,) = read_jsonl(str(metrics))
    assert rec["event"] == "serve.done" and rec["tokens"] == 8
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_serve.main(["--arch", "smollm-135m", "--batch", "2",
                      "--prompt-len", "16", "--gen", "4"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LMEngine(reduced(get_arch("smollm-135m")), lanes=1, prompt_len=4,
                 max_gen=2)


def test_lm_constructors_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    cfg = reduced(get_arch("tinyllama-1.1b"))
    p = tlm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    st = tlm.init_decode_state(cfg, 2, 8, device="cpu")
    assert p["embed"]["table"].device.type == "cpu"
    assert st["scan"]["0_a"]["k"].shape == (cfg.n_layers, 2, 8,
                                            cfg.n_kv_heads, cfg.dh)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlm.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlm.init_decode_state(cfg, 2, 8)


def test_serve_replicas_split_lanes_and_agree():
    cfg = reduced(get_arch("tinyllama-1.1b"), attn_impl="pallas")
    kw = dict(batch=4, prompt_len=12, gen=3, device="cpu", log_fn=None)
    tok1, st1 = t_serve.serve(cfg, replicas=1, **kw)
    tok2, st2 = t_serve.serve(cfg, replicas=2, **kw)
    assert tok1.shape == (4, 3) and torch.equal(tok1, tok2)
    assert st2["replicas"] == 2 and st2["tokens"] == 12
    with pytest.raises(ValueError, match="divide"):
        t_serve.serve(cfg, replicas=3, **kw)


def test_lm_tree_round_trips_through_convert_unchanged():
    """No LM leaf is a 4-D ``"w"`` (the conv rule): the stacked attention
    weights are (units, d, H, dh) under other names, and every leaf crosses
    with its layout."""
    for arch in ARCHS_SLICE:
        jcfg, _ = _cfgs(arch)
        jp, tp = _params(jcfg)
        flat = jax.tree_util.tree_leaves_with_path(jp)
        assert not [p for p, a in flat
                    if getattr(p[-1], "key", None) == "w" and a.ndim == 4]
        assert tp["blocks"]["scan"]["0_a"]["attn"]["wq"].ndim == 4
        back = convert.params_to_numpy(tp)
        jax.tree_util.tree_map(np.testing.assert_array_equal, jp, back)
