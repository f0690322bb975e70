"""The port's RWKV6 slice against the JAX package, on the CPU: the plain
versions of the RWKV6 kernel (``kernels/ref.py``), the wrapper
``ops.rwkv6_chunked_bhsd`` / ``ops.rwkv6_chunked`` on CPU tensors, and
``nn/ssm.py``.  fp32 on both sides (the JAX side under
``jax.enable_x64(False)``); inputs from a numpy seed; the JAX kernel runs
in interpret mode, as the JAX package's own tests run it.

Tolerances, each a normwise bound ``max|port - jax| <= tol * max|jax|``:

- ``CHUNKED_TOL`` (2e-5): the same chunked algorithm in both frameworks.
  They round the per-channel cumsum of logw and the exponentials
  differently, and the exponents reach |cum| ~ 75 at chunk 64, where one
  fp32 ulp is 2**-24 * 75 ~ 4.5e-6 of each factor; the worst measured
  difference is 3.4e-6 of max|out|.
- ``SEQ_TOL`` (2e-6): the sequential recurrence in both; only the order
  of the dh-term sums differs (measured 3.2e-7).
- ``RWKV6_REF_TOL`` (``repro_torch.kernels.rwkv6_cases``): the JAX
  package's own limits for chunked against sequential
  (tests/test_kernels.py: rtol 2e-2, atol 1e-3 in fp32; 0.15 in bf16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # hermetic container: deterministic fallback examples
    from tests._hypothesis_stub import given, settings, st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import rwkv6_chunked_bhsd as j_rwkv6
from repro.nn import ssm as jssm
from repro_torch import convert
from repro_torch.kernels import ops
from repro_torch.kernels.ref import rwkv6_plain, rwkv6_ref
from repro_torch.kernels.rwkv6_cases import (RWKV6_GRID, RWKV6_REF_TOL,
                                             rwkv6_inputs)
from repro_torch.nn import ssm

CHUNKED_TOL = 2e-5
SEQ_TOL = 2e-6


@pytest.fixture(autouse=True)
def _f32():
    with jax.enable_x64(False):
        yield


def _inputs(b, h, s, dh, seed=0, layout="bhsd"):
    """The JAX package's kernel-test inputs from a numpy seed, as arrays."""
    return [t.numpy() for t in rwkv6_inputs(
        b, h, s, dh, np.random.RandomState(seed), layout=layout)]


def _normwise(port, jax_out, tol):
    a = np.asarray(port.detach().float() if torch.is_tensor(port) else port,
                   np.float64)
    b = np.asarray(jax_out, np.float64)
    assert a.shape == b.shape
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
    assert err <= tol, (err, tol)
    return err


# ---------------------------------------------------------------------------
# the kernel's plain versions against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,s,dh,chunk", RWKV6_GRID)
def test_rwkv6_plain_matches_jax_kernel(b, h, s, dh, chunk):
    a = _inputs(b, h, s, dh)
    jo, js = j_rwkv6(*map(jnp.asarray, a), chunk=chunk, interpret=True)
    to, ts = rwkv6_plain(*map(torch.from_numpy, a), chunk=chunk)
    assert to.dtype == torch.float32 and ts.shape == (b, h, dh, dh)
    _normwise(to, jo, CHUNKED_TOL)
    _normwise(ts, js, CHUNKED_TOL)


@pytest.mark.parametrize("b,h,s,dh,chunk", RWKV6_GRID[:2] + RWKV6_GRID[3:])
def test_rwkv6_ref_matches_jax_ref(b, h, s, dh, chunk):
    a = _inputs(b, h, s, dh, seed=1)
    jo, js = jref.rwkv6_ref(*map(jnp.asarray, a))
    to, ts = rwkv6_ref(*map(torch.from_numpy, a))
    _normwise(to, jo, SEQ_TOL)
    _normwise(ts, js, SEQ_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,s,dh,chunk", RWKV6_GRID)
def test_rwkv6_plain_vs_sequential_at_the_jax_limits(b, h, s, dh, chunk,
                                                     dtype):
    """The JAX package's kernel contract (tests/test_kernels.py:100), held
    by the port's chunked plain version against its sequential oracle."""
    tdt = getattr(torch, dtype)
    a = [torch.from_numpy(t).to(tdt) for t in _inputs(b, h, s, dh, seed=2)]
    out, sfin = rwkv6_plain(*a, chunk=chunk)
    oref, sref = rwkv6_ref(*a)
    assert out.dtype == tdt and sfin.dtype == torch.float32
    torch.testing.assert_close(out.float(), oref.float(),
                               **RWKV6_REF_TOL[dtype])
    torch.testing.assert_close(sfin, sref, **RWKV6_REF_TOL[dtype])


@given(s=st.sampled_from([32, 96, 160]), chunk=st.sampled_from([16, 32]),
       dh=st.sampled_from([16, 32]))
@settings(max_examples=10, deadline=None)
def test_rwkv6_chunked_pads_ragged_sequences(s, chunk, dh):
    """The model-layout wrapper pads S with zeros and strips the padding:
    the first S positions match the unpadded sequential oracle, and the
    final state is the unpadded one (a zero step changes nothing)."""
    r, k, v, logw, u = map(torch.from_numpy,
                           _inputs(1, 2, s, dh, seed=s * 7 + chunk,
                                   layout="bshd"))
    out, sfin = ops.rwkv6_chunked(r, k, v, logw, u, chunk=chunk)
    oref, sref = rwkv6_ref(*(t.transpose(1, 2) for t in (r, k, v, logw)), u)
    assert out.shape == r.shape
    torch.testing.assert_close(out, oref.transpose(1, 2),
                               **RWKV6_REF_TOL["float32"])
    torch.testing.assert_close(sfin, sref, **RWKV6_REF_TOL["float32"])


def test_rwkv6_chunk_size_independence():
    """The state carries across chunks: chunk 16 and chunk 64 agree (the
    JAX package's test_rwkv6_state_carries_across_chunks)."""
    a = [torch.from_numpy(t) for t in _inputs(1, 2, 128, 32, seed=3)]
    o1, s1 = rwkv6_plain(*a, chunk=16)
    o2, s2 = rwkv6_plain(*a, chunk=64)
    torch.testing.assert_close(o1, o2, **RWKV6_REF_TOL["float32"])
    torch.testing.assert_close(s1, s2, **RWKV6_REF_TOL["float32"])


def test_rwkv6_plain_from_a_state_continues_the_sequence():
    """``state=`` (the CPU route of a carried state) splits one sequence
    into two calls with the same result."""
    a = [torch.from_numpy(t) for t in _inputs(2, 2, 128, 16, seed=4)]
    o, s = rwkv6_plain(*a, chunk=32)
    o1, s1 = rwkv6_plain(*(t[:, :, :64] for t in a[:4]), a[4], chunk=32)
    o2, s2 = rwkv6_plain(*(t[:, :, 64:] for t in a[:4]), a[4], chunk=32,
                         state=s1)
    torch.testing.assert_close(torch.cat([o1, o2], 2), o, rtol=0, atol=0)
    torch.testing.assert_close(s2, s, rtol=0, atol=0)


def test_rwkv6_wrappers_on_cpu_serve_the_plain_version():
    r, k, v, logw, u = map(torch.from_numpy, _inputs(2, 4, 96, 16, seed=5))
    ops.reset_counts()
    out, sfin = ops.rwkv6_chunked_bhsd(r, k, v, logw, u, chunk=32)
    po, ps = rwkv6_plain(r, k, v, logw, u, chunk=32)
    assert torch.equal(out, po) and torch.equal(sfin, ps)
    assert (ops.rwkv6_plain_calls, ops.rwkv6_launches) == (1, 0)
    # model layout (B,S,H,dh), ragged S, against the JAX package's wrapper
    bs = [t.transpose(1, 2)[:, :90] for t in (r, k, v, logw)]
    jo, js = jops.rwkv6_chunked(*(jnp.asarray(t.numpy()) for t in (*bs, u)),
                                chunk=32)
    o, s = ops.rwkv6_chunked(*bs, u, chunk=32)
    assert o.shape == (2, 90, 4, 16) and ops.rwkv6_plain_calls == 2
    _normwise(o, jo, CHUNKED_TOL)
    _normwise(s, js, CHUNKED_TOL)
    ops.reset_counts()
    assert (ops.rwkv6_plain_calls, ops.rwkv6_launches) == (0, 0)


@pytest.mark.parametrize("case,exc,match", [
    ("dtype", TypeError, "fp32 or bf16"),
    ("mixed_dtype", TypeError, "share one dtype"),
    ("u_shape", ValueError, "u must be"),
    ("rank", ValueError, "B,H,S,dh"),
    ("noncontiguous", ValueError, "contiguous"),
    ("ragged", ValueError, "multiple of"),
    ("autograd", RuntimeError, "autograd"),
])
def test_rwkv6_wrapper_refusals(case, exc, match):
    r, k, v, logw = (torch.zeros(1, 2, 32, 16) for _ in range(4))
    u = torch.zeros(2, 16)
    if case == "dtype":
        r, k, v, logw, u = (t.double() for t in (r, k, v, logw, u))
    elif case == "mixed_dtype":
        u = u.bfloat16()
    elif case == "u_shape":
        u = torch.zeros(16)
    elif case == "rank":
        r = r[0]
    elif case == "noncontiguous":
        r = torch.zeros(1, 32, 2, 16).transpose(1, 2)
    elif case == "ragged":
        r, k, v, logw = (torch.zeros(1, 2, 24, 16) for _ in range(4))
    elif case == "autograd":
        r = r.requires_grad_(True)
    with pytest.raises(exc, match=match):
        ops.rwkv6_chunked_bhsd(r, k, v, logw, u, chunk=16)
    if case == "autograd":
        with torch.no_grad():
            ops.rwkv6_chunked_bhsd(r, k, v, logw, u, chunk=16)  # allowed


# ---------------------------------------------------------------------------
# nn/ssm.py against the JAX package's nn/ssm.py
# ---------------------------------------------------------------------------

D, HEADS = 64, 4


def _tmix(seed=0, d=D, heads=HEADS):
    jp = jssm.init_rwkv6(jax.random.PRNGKey(seed), d, heads)
    jp = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jp)
    return jp, convert.params_from_jax(jp, device="cpu")


def _x(b, s, seed=0, d=D):
    return np.random.RandomState(seed).randn(b, s, d).astype(np.float32)


def test_init_rwkv6_and_channel_mix_follow_the_jax_layout():
    gen = torch.Generator().manual_seed(0)
    tp = ssm.init_rwkv6(gen, D, HEADS, torch.bfloat16, lead=(3,))
    jp = jax.eval_shape(jax.vmap(
        lambda k_: jssm.init_rwkv6(k_, D, HEADS, jnp.bfloat16)),
        jax.random.split(jax.random.PRNGKey(0), 3))
    for name, leaf in jp.items():
        assert tuple(tp[name].shape) == leaf.shape, name
        assert str(tp[name].dtype).replace("torch.", "") == str(leaf.dtype), \
            name
    assert float(tp["w_base"][0, 0]) == -0.5 and float(tp["mix"].min()) == 0.5
    assert abs(float(tp["w_r"].float().std()) - D ** -0.5) < 0.02
    tc = ssm.init_rwkv_channel_mix(gen, D, 96, torch.bfloat16)
    jc = jax.eval_shape(lambda k_: jssm.init_rwkv_channel_mix(
        k_, D, 96, jnp.bfloat16), jax.random.PRNGKey(1))
    assert {n: (tuple(t.shape), str(t.dtype)[6:]) for n, t in tc.items()} \
        == {n: (t.shape, str(t.dtype)) for n, t in jc.items()}


def test_rwkv6_projections_scan_and_decode_match_jax():
    jp, tp = _tmix()
    x = _x(2, 24)
    for j, t in zip(jssm.rwkv6_projections(jp, jnp.asarray(x), HEADS),
                    ssm.rwkv6_projections(tp, torch.from_numpy(x), HEADS)):
        _normwise(t, j, SEQ_TOL)
    jy, js = jssm.rwkv6_mix_scan(jp, jnp.asarray(x), HEADS)
    ty, ts = ssm.rwkv6_mix_scan(tp, torch.from_numpy(x), HEADS)
    _normwise(ty, jy, SEQ_TOL)
    _normwise(ts, js, SEQ_TOL)
    # from a carried state, then one decode step from the result
    x2 = _x(2, 10, seed=1)
    jy2, js2 = jssm.rwkv6_mix_scan(jp, jnp.asarray(x2), HEADS, js)
    ty2, ts2 = ssm.rwkv6_mix_scan(tp, torch.from_numpy(x2), HEADS, ts)
    _normwise(ty2, jy2, SEQ_TOL)
    _normwise(ts2, js2, SEQ_TOL)
    xc = _x(2, 1, seed=2)
    jyd, jsd = jssm.rwkv6_mix_decode(jp, jnp.asarray(x2[:, -1:]),
                                     jnp.asarray(xc), js2, HEADS)
    tyd, tsd = ssm.rwkv6_mix_decode(tp, torch.from_numpy(x2[:, -1:]),
                                    torch.from_numpy(xc), ts2, HEADS)
    assert tyd.shape == (2, 1, D)
    _normwise(tyd, jyd, SEQ_TOL)
    _normwise(tsd, jsd, SEQ_TOL)


def test_rwkv6_mix_chunked_matches_jax_through_the_wrapper():
    """S 300: c = 64, four chunks and 20 positions of zero padding; the
    wrapper serves the plain version for CPU tensors."""
    jp, tp = _tmix(seed=1)
    x = _x(2, 300, seed=3)
    ops.reset_counts()
    jy, js = jssm.rwkv6_mix_chunked(jp, jnp.asarray(x), HEADS)
    ty, ts = ssm.rwkv6_mix_chunked(tp, torch.from_numpy(x), HEADS)
    assert (ops.rwkv6_plain_calls, ops.rwkv6_launches) == (1, 0)
    assert ty.shape == (2, 300, D) and ts.dtype == torch.float32
    _normwise(ty, jy, CHUNKED_TOL)
    _normwise(ts, js, CHUNKED_TOL)
    # the JAX package's own contract: chunked matches the scan oracle
    sy, ss = ssm.rwkv6_mix_scan(tp, torch.from_numpy(x), HEADS)
    torch.testing.assert_close(ty, sy, **RWKV6_REF_TOL["float32"])
    torch.testing.assert_close(ts, ss, **RWKV6_REF_TOL["float32"])
    # a short sequence takes c = S, as the JAX package does
    jy, js = jssm.rwkv6_mix_chunked(jp, jnp.asarray(x[:, :40]), HEADS)
    ty, ts = ssm.rwkv6_mix_chunked(tp, torch.from_numpy(x[:, :40]), HEADS)
    _normwise(ty, jy, CHUNKED_TOL)
    _normwise(ts, js, CHUNKED_TOL)


@pytest.mark.parametrize("s", [65, 130, 257])
def test_rwkv6_mix_chunked_matches_jax_at_ragged_lengths(s):
    """Through ``ops.rwkv6_chunked_fp32`` (the projections as they come, fp32
    out): a ragged last chunk of 1, 2 and 1 positions at c = 64."""
    jp, tp = _tmix(seed=5)
    x = _x(2, s, seed=s)
    ops.reset_counts()
    jy, js = jssm.rwkv6_mix_chunked(jp, jnp.asarray(x), HEADS)
    ty, ts = ssm.rwkv6_mix_chunked(tp, torch.from_numpy(x), HEADS)
    assert (ops.rwkv6_plain_calls, ops.rwkv6_launches) == (1, 0)
    _normwise(ty, jy, CHUNKED_TOL)
    _normwise(ts, js, CHUNKED_TOL)


def test_rwkv6_mix_chunked_from_a_state_runs_on_the_cpu():
    jp, tp = _tmix(seed=2)
    x = _x(2, 100, seed=4)
    js0 = jssm.rwkv6_mix_scan(jp, jnp.asarray(x[:, :30]), HEADS)[1]
    ts0 = ssm.rwkv6_mix_scan(tp, torch.from_numpy(x[:, :30]), HEADS)[1]
    ops.reset_counts()
    jy, js = jssm.rwkv6_mix_chunked(jp, jnp.asarray(x[:, 30:]), HEADS,
                                    js0, chunk=32)
    ty, ts = ssm.rwkv6_mix_chunked(tp, torch.from_numpy(x[:, 30:]), HEADS,
                                   ts0, chunk=32)
    assert (ops.rwkv6_plain_calls, ops.rwkv6_launches) == (0, 0)
    _normwise(ty, jy, CHUNKED_TOL)
    _normwise(ts, js, CHUNKED_TOL)


def test_rwkv_channel_mix_matches_jax():
    jp = jssm.init_rwkv_channel_mix(jax.random.PRNGKey(3), D, 96)
    tp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    x = _x(3, 17, seed=5)
    _normwise(ssm.rwkv_channel_mix(tp, torch.from_numpy(x)),
              jssm.rwkv_channel_mix(jp, jnp.asarray(x)), SEQ_TOL)


def test_group_norm_uses_the_population_variance():
    """dh 4 (16 heads over d 64): the unbiased variance would be 4/3 of
    the population variance, a 13 % change of every normalised value."""
    jp, tp = _tmix(seed=4, heads=16)
    rs = np.random.RandomState(6)
    y = rs.randn(2, 5, 16, 4).astype(np.float32)
    g = rs.randn(2, 5, D).astype(np.float32)
    j = jssm._rwkv_out(jp, jnp.asarray(y), jnp.asarray(g), jnp.float32,
                       2, 5, D)
    t = ssm._rwkv_out(tp, torch.from_numpy(y), torch.from_numpy(g),
                      torch.float32, 2, 5, D)
    _normwise(t, j, SEQ_TOL)
    yt = torch.from_numpy(y)
    mu = yt.mean(-1, keepdim=True)
    unbiased = ((yt - mu) * torch.rsqrt(yt.var(-1, keepdim=True) + 1e-5)
                * tp["ln_scale"]).reshape(2, 5, D) * torch.nn.functional.silu(
        torch.from_numpy(g)) @ tp["w_o"]
    err = float((unbiased - t).abs().max() / t.abs().max())
    assert err > 100 * SEQ_TOL, err

