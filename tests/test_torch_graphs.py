"""Graph capture, the port's counterpart of ``jax.jit``, on the CPU.

What a CPU run can hold: the decode step with its position as a 0-d
tensor (what a CUDA graph captures) against the Python-int position
(bitwise) and against the JAX package's ``decode_step`` (LM_TOL, as
``tests/test_torch_lm.py``); ``StepGraph``'s argument contract, which the
CPU path shares with the card (refusals, static or cloned outputs); and
``LMEngine``'s static-state protocol (warm-up and capture on the static
state, each wave's prefill state copied in) against the JAX engine's
tokens over two waves, plus its ``aging`` dispatch order.  The graphs
themselves are held against eager runs on the card in
``tests/test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType
from torch.utils import _pytree as pytree

from repro.configs.base import reduced as j_reduced
from repro.configs.registry import get_arch as j_get_arch
from repro.models import lm as jlm
from repro.serve import LMEngine as JLMEngine
from repro_torch import convert
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_arch
from repro_torch.launch.graphs import StepGraph
from repro_torch.models import lm as tlm
from repro_torch.nn.attention import decode_position
from repro_torch.serve import LMEngine

LM_TOL = dict(rtol=2e-5, atol=2e-5)   # tests/test_torch_lm.py
ARCHS = ["tinyllama-1.1b", "rwkv6-7b"]


@pytest.fixture(autouse=True)
def _f32():
    with jax.enable_x64(False):
        yield


def _cfgs(arch):
    kw = {"n_layers": 2} if arch == "rwkv6-7b" else {}
    return (j_reduced(j_get_arch(arch), **kw), reduced(get_arch(arch), **kw))


def _params(jcfg, seed=0):
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    jp = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jp)
    return jp, convert.params_from_jax(jp, device="cpu")


def _tokens(b, s, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (b, s)).astype(
        np.int32)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _same_bits(a, b):
    return all(torch.equal(_bits(x), _bits(y)) for x, y in
               zip(pytree.tree_leaves(a), pytree.tree_leaves(b)))


# ---------------------------------------------------------------------------
# the decode position as a tensor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_tensor_position_is_bitwise_the_int_position(arch):
    _, cfg = _cfgs(arch)
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    toks = torch.from_numpy(_tokens(2, 12))
    with torch.no_grad():
        st_int, last = tlm.prefill(cfg, params, {"tokens": toks}, 20)
        st_t32 = pytree.tree_map(torch.clone, st_int)
        st_t64 = pytree.tree_map(torch.clone, st_int)
        tok = torch.argmax(last, -1)[:, None]
        for i in range(6):
            lg, st_int = tlm.decode_step(cfg, params, st_int, tok, 12 + i)
            l32, st_t32 = tlm.decode_step(cfg, params, st_t32, tok,
                                          torch.tensor(12 + i,
                                                       dtype=torch.int32))
            l64, st_t64 = tlm.decode_step(cfg, params, st_t64, tok,
                                          torch.tensor(12 + i))
            assert _same_bits(lg, l32) and _same_bits(lg, l64)
            assert _same_bits(st_int, st_t32) and _same_bits(st_int, st_t64)
            tok = torch.argmax(lg, -1)[:, None]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_tensor_position_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    toks = _tokens(2, 10, seed=3)
    with torch.no_grad():
        jst, jlast = jlm.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, 16)
        tst, _ = tlm.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                             16)
        tok = np.asarray(jnp.argmax(jlast, -1))[:, None].astype(np.int32)
        pos = torch.zeros((), dtype=torch.long)
        for i in range(4):
            jlg, jst = jlm.decode_step(jcfg, jp, jst, jnp.asarray(tok),
                                       jnp.int32(10 + i))
            pos.fill_(10 + i)
            tlg, tst = tlm.decode_step(tcfg, tp, tst, torch.from_numpy(tok),
                                       pos)
            np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg),
                                       **LM_TOL)
            tok = np.asarray(jnp.argmax(jlg, -1))[:, None].astype(np.int32)
    jax.tree_util.tree_map(
        lambda a, c: np.testing.assert_allclose(c, a, **LM_TOL),
        jax.tree_util.tree_map(np.asarray, jst),
        convert.params_to_numpy(tst))


def test_decode_position_refuses_what_a_graph_cannot_read():
    p = decode_position(7, "cpu")
    assert p.dim() == 0 and p.dtype == torch.long and int(p) == 7
    t = torch.tensor(3, dtype=torch.int32)
    assert decode_position(t, "cpu").dtype == torch.long
    for bad in (torch.tensor([3]), torch.tensor(3.0), torch.tensor(True)):
        with pytest.raises(ValueError, match="0-d integer tensor"):
            decode_position(bad, "cpu")
    with pytest.raises(ValueError, match="0-d integer tensor"):
        decode_position(torch.tensor(3, device="meta"), "cpu")


# ---------------------------------------------------------------------------
# StepGraph's contract (shared by the CPU path and the card)
# ---------------------------------------------------------------------------

def _axpy(held, copied):
    return {"y": held["a"] * copied[0] + copied[1]}


def test_step_graph_refuses_changed_held_and_wrong_copied():
    a = torch.arange(4.0)
    g = StepGraph(_axpy, clone_outputs=True)
    out = g({"a": a}, (torch.ones(4), torch.zeros(4)))
    assert torch.equal(out["y"], a)
    assert g.captured and g.graph is None and g.capture_ms is None
    with pytest.raises(ValueError, match="not the tensor captured"):
        g({"a": a.clone()}, (torch.ones(4), torch.zeros(4)))
    with pytest.raises(ValueError, match="not the tensor captured"):
        g({"a": a[:2]}, (torch.ones(4), torch.zeros(4)))
    with pytest.raises(ValueError, match="structure"):
        g({"b": a}, (torch.ones(4), torch.zeros(4)))
    with pytest.raises(ValueError, match="copied leaf 0"):
        g({"a": a}, (torch.ones(5), torch.zeros(4)))
    with pytest.raises(ValueError, match="copied leaf 1"):
        g({"a": a}, (torch.ones(4), torch.zeros(4, dtype=torch.float64)))
    with pytest.raises(ValueError, match="copied leaf 1"):
        g({"a": a}, (torch.ones(4), torch.zeros(4, device="meta")))
    with pytest.raises(TypeError, match="must be a tensor"):
        g({"a": a}, (torch.ones(4), 0.0))
    with pytest.raises(ValueError, match="one device"):
        StepGraph(_axpy, clone_outputs=True)(
            {"a": a}, (torch.ones(4), torch.zeros(4, device="meta")))
    # the held tensor's values may change: the graph reads its address
    a.mul_(2)
    assert torch.equal(g({"a": a}, (torch.ones(4), torch.ones(4)))["y"],
                       a + 1)


def test_step_graph_outputs_are_static_or_cloned():
    a = torch.arange(3.0)
    static = StepGraph(_axpy, clone_outputs=False)
    cloned = StepGraph(_axpy, clone_outputs=True)
    x1, x2 = (torch.ones(3), torch.zeros(3)), (torch.full((3,), 2.0),
                                                 torch.ones(3))
    s1, c1 = static({"a": a}, x1), cloned({"a": a}, x1)
    s2, c2 = static({"a": a}, x2), cloned({"a": a}, x2)
    assert s1["y"] is s2["y"] and torch.equal(s1["y"], 2 * a + 1)
    assert torch.equal(c1["y"], a) and torch.equal(c2["y"], 2 * a + 1)
    # the copied arguments went into static buffers, not the caller's
    src = torch.ones(3)
    cloned({"a": a}, (src, torch.zeros(3)))
    assert cloned._inputs[0] is not src


# ---------------------------------------------------------------------------
# LMEngine: the static decode state, two waves, aging
# ---------------------------------------------------------------------------

def _auto_mesh():
    # jax 0.9's default mesh has Explicit axes, which the JAX package's
    # attention sharding pins refuse; its LMEngine takes a mesh argument
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_engine_two_waves_through_the_static_state_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    prompts = _tokens(4, 12, seed=5)
    kw = dict(lanes=2, prompt_len=12, max_gen=7, decode_slice=3)
    je = JLMEngine(jcfg, params=jp, mesh=_auto_mesh(), **kw)
    te = LMEngine(tcfg, params=tp, device="cpu", **kw)
    static = [(t.data_ptr(), t.shape) for t in
              pytree.tree_leaves(te._state)]
    jt = [je.submit(p) for p in prompts]
    tt = [te.submit(p) for p in prompts]
    je.run()
    te.run()
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(b.result(1.0), a.result(1.0))
    assert [c["op"] for c in te.call_log].count("prefill") == 2
    # both waves decoded on the one static state the graph was bound to
    assert te.decode_graph.captured
    assert [(t.data_ptr(), t.shape) for t in
            pytree.tree_leaves(te._state)] == static
    assert te.static_state_bytes == sum(
        t.numel() * t.element_size()
        for t in pytree.tree_leaves(tlm.init_decode_state(
            tcfg, 2, 19, device="cpu")))


@pytest.mark.parametrize("aging,first", [(0.0, "high"), (1.0, "low")])
def test_lm_engine_aging_sets_the_dispatch_order(aging, first):
    _, cfg = _cfgs("tinyllama-1.1b")
    eng = LMEngine(cfg, lanes=1, prompt_len=4, max_gen=2, decode_slice=1,
                   device="cpu", aging=aging)
    assert eng.queue.aging == aging
    low = eng.submit(_tokens(1, 4)[0], priority=0.0)
    for _ in range(3):
        eng.queue.next_batch(0)  # ticks pass, the waiting request ages
    high = eng.submit(_tokens(1, 4, seed=1)[0], priority=2.5)
    eng.run()
    # one lane: the first request dispatched completes first.  At the
    # dispatch tick 4, aging 1 scores low 0 + 4 = 4 over high 2.5 + 1 = 3.5;
    # aging 0 is strict priority
    order = sorted((("low", low), ("high", high)),
                   key=lambda kv: kv[1].complete_tick)
    assert order[0][0] == first
    assert order[0][1].complete_tick < order[1][1].complete_tick
