"""The donated train step (``AdamW.update_``, ``make_train_step(donate=
True)``, the loop in ``launch/train.py``) on the CPU, BITWISE against the
functional step it replaces: the same operations in the same order, so the
same bits, with the params, the moments and int8's residual written in
place.  Also the checkpoint taken just before an in-place step, which must
restore the pre-step bits.  Reduced configs, a few steps; no JAX: the
functional step is held against the JAX package in test_torch_train.py.
"""
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs.base import ShapeCell, reduced
from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import steps as steps_mod
from repro_torch.launch import train as train_mod
from repro_torch.launch.steps import init_compress_state, make_train_step
from repro_torch.models import lm
from repro_torch.optim import compress as compress_mod
from repro_torch.optim.adamw import AdamW

OPT = dict(lr=1e-3, eps=1e-3, warmup_steps=1, total_steps=10)


def _bits(x):
    return x.contiguous().view(torch.uint8) if x.dtype != torch.uint8 else x


def _same(a, b):
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if not torch.is_tensor(x):
            assert x == y
            continue
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(_bits(x), _bits(y))


def _copy(tree):
    return pytree.tree_map(lambda t: t.clone() if torch.is_tensor(t) else t,
                           tree)


def _tree(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g).to(dtype)  # noqa: E731
    return {"a": {"w": mk(5, 7), "b": mk(7)}, "c": [mk(3, 2, 4), mk(1)]}


# ---------------------------------------------------------------------------
# AdamW.update_
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad_scale", [1e-2, 1e2], ids=["unclipped",
                                                          "clipped"])
@pytest.mark.parametrize("grad_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_update_in_place_is_update_bitwise(dtype, grad_dtype, grad_scale):
    opt = AdamW(grad_dtype=grad_dtype, **OPT)
    params = _tree(dtype)
    ref_p, ref_s = params, opt.init(params)
    don_p, don_s = _copy(params), opt.init(params)
    leaves = pytree.tree_leaves(don_p)
    for step in range(3):
        grads = pytree.tree_map(lambda t: t * grad_scale,
                                _tree(dtype, seed=10 + step))
        ref_p, ref_s, ref_m = opt.update(grads, ref_s, ref_p)
        out_p, don_s, m = opt.update_(grads, don_s, don_p)
        assert out_p is don_p and don_s.step == ref_s.step == step + 1
        _same(don_p, ref_p)
        _same((don_s.m, don_s.v), (ref_s.m, ref_s.v))
        assert torch.equal(m["grad_norm"], ref_m["grad_norm"])
        assert m["lr"] == ref_m["lr"]
    # the same tensors throughout: nothing was replaced
    assert all(a is b for a, b in zip(leaves, pytree.tree_leaves(don_p)))


def test_update_in_place_decodes_each_leaf():
    """int8's payload decoded leaf by leaf inside ``update_`` equals
    ``update`` on ``int8_decompress``'s fp32 tree."""
    opt = AdamW(**OPT)
    params = _tree(torch.bfloat16)
    grads = _tree(torch.float32, seed=3)
    q, _ = compress_mod.int8_compress(grads, compress_mod.int8_init(grads))
    ref_p, ref_s, ref_m = opt.update(compress_mod.int8_decompress(q),
                                     opt.init(params), params)
    pairs = pytree.tree_leaves(q, is_leaf=lambda x: isinstance(x, tuple))
    don_p, don_s, m = opt.update_(
        pairs, opt.init(params), _copy(params),
        decode=lambda pair: compress_mod.int8_dequantize(*pair))
    _same((don_p, don_s.m, don_s.v), (ref_p, ref_s.m, ref_s.v))
    assert torch.equal(m["grad_norm"], ref_m["grad_norm"])
    with pytest.raises(ValueError, match="gradient leaves"):
        opt.update_(pairs[:-1], opt.init(params), params,
                    decode=lambda pair: compress_mod.int8_dequantize(*pair))


# ---------------------------------------------------------------------------
# make_train_step(donate=True)
# ---------------------------------------------------------------------------

def _setup(arch="recurrentgemma-9b", s=16, b=2):
    cfg = reduced(get_arch(arch), attn_impl="chunked")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    rs = np.random.RandomState(0)
    batches = []
    for _ in range(3):
        t = torch.from_numpy(rs.randint(0, cfg.vocab_size, (b, s)).astype(
            np.int32))
        batches.append({"tokens": t, "targets": t})
    return cfg, params, batches


@pytest.mark.parametrize("compress", [None, "bf16", "int8"])
def test_donated_step_is_the_functional_step_bitwise(compress):
    """Three steps with the sentinel on, the second poisoned: the donated
    step skips it without touching a tensor (int8's residual keeps its
    bits), and every step's params, moments, residual and metrics are the
    functional step's."""
    cfg, params, batches = _setup()
    opt = AdamW(**OPT)
    fun = make_train_step(cfg, opt, compress=compress, sentinel=True)
    don = make_train_step(cfg, opt, compress=compress, sentinel=True,
                          donate=True)
    int8 = compress == "int8"
    f_p, f_s = params, opt.init(params)
    d_p, d_s = _copy(params), opt.init(params)
    f_c = init_compress_state(compress, params)
    d_c = init_compress_state(compress, params)
    held = pytree.tree_leaves((d_p, d_s.m, d_s.v, d_c))
    for i, poison in enumerate((False, True, False)):
        before = _copy((d_p, d_s.m, d_s.v, d_c))
        if int8:
            f_p, f_s, f_c, fm = fun(f_p, f_s, f_c, batches[i], i, poison)
            d_p, d_s, d_c, dm = don(d_p, d_s, d_c, batches[i], i, poison)
        else:
            f_p, f_s, fm = fun(f_p, f_s, batches[i], i, poison)
            d_p, d_s, dm = don(d_p, d_s, batches[i], i, poison)
        assert d_s.step == f_s.step
        assert int(dm["nonfinite"]) == int(fm["nonfinite"]) == int(poison)
        _same((d_p, d_s.m, d_s.v, d_c), (f_p, f_s.m, f_s.v, f_c))
        if poison:
            _same((d_p, d_s.m, d_s.v, d_c), before)
        else:
            assert torch.equal(dm["loss"], fm["loss"])
            assert torch.equal(dm["grad_norm"], fm["grad_norm"])
    assert f_s.step == 2
    # written in place: the caller's tensors are the step's
    assert all(a is b for a, b in zip(
        held, pytree.tree_leaves((d_p, d_s.m, d_s.v, d_c))))
    if int8:
        assert any(bool(r.any()) for r in pytree.tree_leaves(d_c))


def test_donated_step_with_accumulation_and_no_sentinel():
    cfg, params, batches = _setup("tinyllama-1.1b", b=4)
    opt = AdamW(**OPT)
    fun = make_train_step(cfg, opt, accum=2)
    don = make_train_step(cfg, opt, accum=2, donate=True)
    f_p, f_s = params, opt.init(params)
    d_p, d_s = _copy(params), opt.init(params)
    for i in range(2):
        f_p, f_s, fm = fun(f_p, f_s, batches[i], i)
        d_p, d_s, dm = don(d_p, d_s, batches[i], i)
        assert "nonfinite" not in dm
        _same((d_p, d_s.m, d_s.v), (f_p, f_s.m, f_s.v))
        assert torch.equal(dm["grad_norm"], fm["grad_norm"])


def test_checkpoint_before_a_donated_step_restores_the_pre_step_bits(
        tmp_path):
    cfg, params, batches = _setup()
    opt = AdamW(**OPT)
    step = make_train_step(cfg, opt, compress="int8", donate=True)
    state, comp = opt.init(params), init_compress_state("int8", params)
    params, state, comp, _ = step(params, state, comp, batches[0], 0)
    tree = {"params": params, "opt_state": state, "comp_state": comp}
    pre = _copy(tree)
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, tree)
    params, state, comp, _ = step(params, state, comp, batches[1], 1)
    assert not torch.equal(pytree.tree_leaves(params)[0],
                           pytree.tree_leaves(pre["params"])[0])
    restored, at = mgr.restore_latest(
        {"params": params, "opt_state": state, "comp_state": comp})
    assert at == 1 and restored["opt_state"].step == 1
    _same(restored, pre)


def test_train_loop_takes_the_donated_step(monkeypatch):
    """``launch/train.py`` builds the donated step, and its run commits the
    losses and params of the functional step driven by hand."""
    cfg = reduced(get_arch("recurrentgemma-9b"))
    cell = ShapeCell("t", 16, 2, "train")
    seen = []
    real = steps_mod.make_train_step

    def spy(*a, **kw):
        seen.append(kw.get("donate"))
        return real(*a, **kw)

    monkeypatch.setattr(train_mod, "make_train_step", spy)
    out = train_mod.train(cfg, cell, steps=3, log_fn=lambda *a: None,
                          device="cpu")
    assert seen == [True]
    opt = AdamW(lr=3e-4, total_steps=3, warmup_steps=1)
    params = lm.init_params(cfg, torch.Generator("cpu").manual_seed(0),
                            device="cpu")
    state = opt.init(params)
    fun = real(cfg, opt, sentinel=True)
    pipe = SyntheticLM(cfg, cell, seed=0)
    losses = []
    for i in range(3):
        params, state, m = fun(params, state, pipe.batch(i), i)
        losses.append(float(m["loss"]))
    assert out["losses"] == losses
    _same(out["params"], params)
