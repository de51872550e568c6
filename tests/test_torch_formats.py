"""Port parity: CP formats, contractions and the port's own rules.

The port's ``inner_cp_cp``, ``distance`` and ``cosine_similarity`` against
``repro.core.contractions`` on the same numpy inputs (rtol 1e-5: both sides
sum a few hundred fp32 products in different orders, a rounding error of
order 1e-6 relative at these sizes, and the inputs keep clear of
cancellation). The generator samplers are checked by distribution, the RNGs
never being the same. Two rules of the port are checked here as well: it
imports nothing of JAX or the reference, and asking for the card where there
is none raises.
"""

import ast
import math
from pathlib import Path

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

import torch_bridge as tb
from repro.core import contractions as jcon
from repro.core import tensor_formats as jtf
from repro_torch.core import contractions as tcon
from repro_torch.core import tensor_formats as ttf

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5


def _pair(seed, dims=(3, 4, 5), rx=2, ry=3):
    rng = np.random.default_rng(seed)
    x = [rng.normal(size=(d, rx)).astype(np.float32) for d in dims]
    y = [rng.normal(size=(d, ry)).astype(np.float32) for d in dims]
    return x, y


@pytest.mark.parametrize("fn", ["inner", "distance", "cosine_similarity",
                                "norm"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cp_contractions_match_reference(fn, seed):
    x, y = _pair(seed)
    jx, jy = tb.jax_cp(x, 0.5), tb.jax_cp(y, 1.5)
    tx, ty = tb.torch_cp(x, 0.5), tb.torch_cp(y, 1.5)
    if fn == "norm":
        ref, got = jcon.norm(jx), tcon.norm(tx)
    else:
        ref, got = getattr(jcon, fn)(jx, jy), getattr(tcon, fn)(tx, ty)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)


def test_inner_cp_cp_matches_dense_oracle():
    x, y = _pair(3)
    tx, ty = tb.torch_cp(x, 0.7), tb.torch_cp(y)
    dense = tcon.inner_dense_dense(ttf.cp_to_dense(tx), ttf.cp_to_dense(ty))
    np.testing.assert_allclose(tcon.inner_cp_cp(tx, ty).numpy(),
                               dense.numpy(), rtol=RTOL)
    ref = jtf.cp_to_dense(tb.jax_cp(x, 0.7))
    np.testing.assert_allclose(ttf.cp_to_dense(tx).numpy(), np.asarray(ref),
                               rtol=RTOL, atol=1e-6)


def test_cp_rademacher_distribution():
    gen = torch.Generator().manual_seed(0)
    p = ttf.cp_rademacher(gen, (6, 7, 8), rank=5, batch=400)
    vals = torch.cat([f.reshape(-1) for f in p.factors])
    assert set(torch.unique(vals).tolist()) == {-1.0, 1.0}
    assert abs(float(vals.mean())) < 0.02           # 2e4+ fair signs
    assert p.scale == pytest.approx(1 / math.sqrt(5))
    assert p.dims == (6, 7, 8) and p.rank == 5


def test_cp_random_data_distribution():
    gen = torch.Generator().manual_seed(1)
    x = ttf.cp_random_data(gen, (4, 9), rank=3, batch=2000)
    for f, d in zip(x.factors, (4, 9)):
        assert f.shape == (2000, d, 3)
        # N(0, 1/d) entries: the sample std within 3% at 2.4e4+ draws
        assert float(f.std()) == pytest.approx(1 / math.sqrt(d), rel=0.03)
    assert x.scale == 1.0


def _port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_reference():
    bad = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert len(_port_sources()) > 10
    assert not bad, bad


def test_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch.serving.lsh_service import build_service
    corpus, _ = tb.cp_fixture(8, 1)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="cuda"):
        build_service(gen, "cp-e2lsh", tb.DIMS, tb.torch_cp(corpus))
