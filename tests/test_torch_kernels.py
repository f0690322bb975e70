"""The port's kernel wrappers on the CPU (where they serve the plain
versions) and the port's packaging rules: no JAX behind ``import
repro_torch``, entry points that run on the card unless the caller asks for
the CPU.

``lincomb_plain`` is held bitwise against the JAX package's EAGER oracle
``kernels/ref.py::lincomb_ref``: both round every multiply and every add.
``attention_plain`` is held against the JAX package's Pallas
``flash_attention_bhsd`` in interpret mode over ``tests/test_kernels.py``'s
grid, with that file's tolerances (fp32 rtol = atol = 2e-5, bf16 5e-2).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention_bhsd as j_flash
from repro.kernels.ref import attention_ref, lincomb_ref
from repro_torch.kernels import _build, ops
from repro_torch.kernels.ref import attention_plain, lincomb_plain

jax.config.update("jax_enable_x64", True)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
WEIGHTS = [0.5, -0.25, 1 / 3, 2.0, -7 / 9, 0.1, 1e-3]


def _operands(shape, dtype, n_terms, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape).astype(dtype),
            [rs.randn(*shape).astype(dtype) for _ in range(n_terms)])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n_terms", [1, 4, 7])
@pytest.mark.parametrize("scale,base_coeff", [(None, None), (0.1, None),
                                              (None, 0.0), (0.37, -1.5),
                                              ("tensor", 2 / 3)])
def test_lincomb_plain_bitwise_vs_eager_jax_oracle(dtype, n_terms, scale,
                                                   base_coeff):
    base, terms = _operands((37,), dtype, n_terms)
    ws = WEIGHTS[:n_terms]
    if scale == "tensor":
        j_scale = jnp.asarray(0.013, dtype)
        t_scale = torch.tensor(0.013, dtype=torch.from_numpy(base).dtype)
    else:
        j_scale = t_scale = scale
    ref = lincomb_ref(jnp.asarray(base), [jnp.asarray(t) for t in terms], ws,
                      scale=j_scale, base_coeff=base_coeff)
    out = lincomb_plain(torch.from_numpy(base),
                        [torch.from_numpy(t) for t in terms], ws,
                        scale=t_scale, base_coeff=base_coeff)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_fused_lincomb_on_cpu_serves_the_plain_version():
    base, terms = _operands((4, 5), np.float64, 3)
    b, ts = torch.from_numpy(base), [torch.from_numpy(t) for t in terms]
    ops.reset_counts()
    out = ops.fused_lincomb(b, ts, WEIGHTS[:3], scale=0.2, base_coeff=0.5)
    assert torch.equal(out, lincomb_plain(b, ts, WEIGHTS[:3], 0.2, 0.5))
    assert (ops.plain_calls, ops.launches) == (1, 0)
    # 0-dim leaves and base_coeff=0.0 multiplying (NaN and -0 propagate)
    z = torch.tensor(float("nan"), dtype=torch.float64)
    out0 = ops.fused_lincomb(z, [torch.tensor(1.0, dtype=torch.float64)],
                             [1.0], base_coeff=0.0)
    assert out0.shape == () and torch.isnan(out0)
    neg = torch.tensor([-1.0, 1.0], dtype=torch.float64)
    zero = torch.zeros(2, dtype=torch.float64)
    out1 = ops.fused_lincomb(neg, [zero], [-1.0], base_coeff=0.0)
    assert torch.equal(torch.signbit(out1), torch.tensor([True, False]))


def test_fused_lincomb_validates_its_operands():
    b = torch.zeros(6)
    with pytest.raises(ValueError, match="match base"):
        ops.fused_lincomb(b, [torch.zeros(5)], [1.0])
    with pytest.raises(ValueError, match="match base"):
        ops.fused_lincomb(b, [torch.zeros(6, dtype=torch.float64)], [1.0])
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_lincomb(torch.zeros(3, 2).t(), [torch.zeros(3, 2).t()],
                          [1.0])
    with pytest.raises(ValueError, match="one weight per term"):
        ops.fused_lincomb(b, [b], [1.0, 2.0])
    with pytest.raises(ValueError, match="tensor scale"):
        ops.fused_lincomb(b, [b], [1.0], scale=torch.zeros(2))
    with pytest.raises(RuntimeError, match="autograd"):
        ops.fused_lincomb(torch.zeros(6, requires_grad=True), [b], [1.0])


def test_build_needs_nvcc_and_hashes_the_sources(monkeypatch, tmp_path):
    assert (PORT / "csrc" / "lincomb.cu").exists()
    assert (PORT / "csrc" / "flash_attention.cu").exists()
    assert _build.build_dir() == _build.build_dir()
    assert _build.build_dir().parent == ROOT / "build" / "repro_torch_kernels"
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax_and_no_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    names = {f.relative_to(PORT).as_posix() for f in files[:-1]}
    assert {"nn/attention.py", "nn/transformer.py", "models/lm.py",
            "serve/engine.py", "serve/queue.py", "launch/serve.py",
            "configs/tinyllama_1_1b.py", "obs/sink.py"} <= names
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)


def test_import_repro_torch_loads_no_jax():
    code = ("import importlib, pkgutil, sys, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "import repro_torch.launch.serve, repro_torch.serve.engine\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'repro' not in sys.modules, 'repro imported'\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    from repro_torch.examples import cnf_density, image_classification
    from repro_torch.models import ode_nets

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    for init, args in [(ode_nets.classifier_init, ()),
                       (ode_nets.cnf_vf_init, (6,)),
                       (ode_nets.conv_vf_init, (4,)),
                       (ode_nets.mlp_vf_init, (3,))]:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init(gen, *args)
        init(gen, *args, device="cpu")
    for main in (image_classification.main, cnf_density.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main([])


@pytest.mark.parametrize("mod,argv", [
    ("image_classification", ["--steps", "2", "--batch", "4",
                              "--channels", "4", "--image-size", "8",
                              "--eval-batch", "8"]),
    ("cnf_density", ["--iters", "2", "--batch", "16", "--n-steps", "2",
                     "--hidden", "8", "--test-batch", "16", "--samples", "2"]),
])
def test_examples_run_on_cpu(mod, argv, capsys):
    import importlib
    importlib.import_module(f"repro_torch.examples.{mod}").main(
        argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "step" in out or "iter" in out


# ---------------------------------------------------------------------------
# flash attention: the plain version against the TPU kernel (interpret mode)
# ---------------------------------------------------------------------------

FLASH_TOL = {np.float32: dict(rtol=2e-5, atol=2e-5),
             "bfloat16": dict(rtol=5e-2, atol=5e-2)}


def _qkv_np(b, h, hkv, sq, sk, dh, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, h, sq, dh).astype(np.float32),
            rs.randn(b, hkv, sk, dh).astype(np.float32),
            rs.randn(b, hkv, sk, dh).astype(np.float32))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("b,h,hkv,s,dh,bq,bk", [
    (1, 4, 4, 128, 64, 64, 64),     # MHA
    (2, 4, 2, 128, 64, 64, 64),     # GQA 2:1
    (1, 8, 1, 256, 32, 128, 64),    # MQA
    (1, 4, 4, 200, 64, 128, 128),   # ragged: S not multiple of block
    (1, 2, 2, 64, 128, 64, 64),     # wide head
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48),
                                           (False, 0)])
def test_attention_plain_matches_jax_flash_kernel(b, h, hkv, s, dh, bq, bk,
                                                  causal, window, dtype):
    qkv = _qkv_np(b, h, hkv, s, s, dh)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    with jax.enable_x64(False):
        j = j_flash(*(jnp.asarray(a).astype(jdt) for a in qkv),
                    causal=causal, window=window, block_q=bq, block_k=bk,
                    interpret=True)
    t = attention_plain(*(torch.from_numpy(a).to(tdt) for a in qkv),
                        causal=causal, window=window)
    assert t.dtype == tdt and t.shape == (b, h, s, dh)
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **FLASH_TOL[dtype])


def test_attention_plain_cross_lengths_and_reference_oracle():
    """Sq != Sk, and the same contract as the JAX package's own oracle."""
    q, k, v = _qkv_np(1, 4, 4, 64, 192, 64, seed=1)
    with jax.enable_x64(False):
        j = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=False, block_q=64, block_k=64, interpret=True)
        r = attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, window=16)
    t = attention_plain(*map(torch.from_numpy, (q, k, v)), causal=False)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-5,
                               atol=2e-5)
    t = attention_plain(*map(torch.from_numpy, (q, k, v)), causal=True,
                        window=16)
    np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=2e-5,
                               atol=2e-5)


def test_flash_wrappers_on_cpu_serve_the_plain_version():
    q, k, v = map(torch.from_numpy, _qkv_np(2, 4, 2, 40, 40, 32, seed=2))
    ops.reset_counts()
    out = ops.flash_attention_bhsd(q, k, v, causal=True, window=8)
    assert torch.equal(out, attention_plain(q, k, v, causal=True, window=8))
    assert (ops.flash_plain_calls, ops.flash_launches) == (1, 0)
    # model layout (B,S,H,Dh), as the JAX package's ops.flash_attention
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))  # strided views
    with jax.enable_x64(False):
        j = jops.flash_attention(*(jnp.asarray(t.numpy()) for t in
                                   (qs, ks, vs)), causal=True, block_q=32,
                                 block_k=32)
    o = ops.flash_attention(qs, ks, vs, causal=True)
    assert o.shape == (2, 40, 4, 32) and ops.flash_plain_calls == 2
    np.testing.assert_allclose(o.numpy(), np.asarray(j), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("case,exc,match", [
    ("dtype", TypeError, "fp32 or bf16"),
    ("mixed_dtype", TypeError, "share one dtype"),
    ("noncontiguous", ValueError, "contiguous"),
    ("gqa", ValueError, "multiple of"),
    ("head_dim", ValueError, "head dim"),
    ("rank", ValueError, "B,H,Sq,Dh"),
    ("autograd", RuntimeError, "autograd"),
])
def test_flash_wrapper_refusals(case, exc, match):
    q = torch.zeros(1, 4, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    v = torch.zeros(1, 2, 8, 16)
    if case == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif case == "mixed_dtype":
        k = k.bfloat16()
    elif case == "noncontiguous":
        q = torch.zeros(1, 8, 4, 16).transpose(1, 2)
    elif case == "gqa":
        k = v = torch.zeros(1, 3, 8, 16)
    elif case == "head_dim":
        q, k, v = (torch.zeros(t.shape[:3] + (48,)) for t in (q, k, v))
    elif case == "rank":
        q = q[0]
    elif case == "autograd":
        q = q.requires_grad_(True)
    with pytest.raises(exc, match=match):
        ops.flash_attention_bhsd(q, k, v)
    if case == "autograd":
        with torch.no_grad():
            ops.flash_attention_bhsd(q, k, v)  # nothing recorded: allowed
