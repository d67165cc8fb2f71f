"""hebo_tpu_torch's host modules (design space, padding, transforms) against
hebo_tpu, and the port's import boundary.

These pieces are numpy/scipy on both sides, so they must agree exactly
(the scalers, which are tensor code in the port, to float32 rounding:
rtol 1e-6).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from hebo_tpu.design_space import DesignSpace as JSpace
from hebo_tpu.ops import transforms as jtr
from hebo_tpu.utils.dtypes import pad_bucket as jpad
from hebo_tpu_torch.design_space import DesignSpace
from hebo_tpu_torch.ops import transforms as ttr
from hebo_tpu_torch.utils.dtypes import pad_bucket

REPO = Path(__file__).resolve().parent.parent

SPECS = [
    {"name": "n", "type": "num", "lb": -2.0, "ub": 2.0},
    {"name": "p", "type": "pow", "lb": 1e-4, "ub": 1.0},
    {"name": "i", "type": "int", "lb": 0, "ub": 7},
    {"name": "pi", "type": "pow_int", "lb": 1, "ub": 1024},
    {"name": "ie", "type": "int_exponent", "lb": 16, "ub": 1024, "base": 2},
    {"name": "si", "type": "step_int", "lb": 10, "ub": 50, "step": 10},
    {"name": "b", "type": "bool"},
    {"name": "c", "type": "cat", "categories": ["red", "green", "blue"]},
    {"name": "o", "type": "ordinal", "categories": [1, 2, 5]},
    {"name": "s", "type": "sigmoid", "lb": 0.01, "ub": 0.99},
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The many small ops here run no faster on more threads, and the
    test run's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_pad_bucket_matches():
    for n in list(range(1, 2100, 7)) + [2048, 2049, 4000]:
        assert pad_bucket(n) == jpad(n)


@pytest.mark.parametrize("specs", [SPECS, [{"name": "perm", "type": "perm", "length": 4},
                                           {"name": "x", "type": "num", "lb": 0, "ub": 1}]])
def test_design_space_frames_match(specs):
    js, ts = JSpace(specs), DesignSpace(specs)
    for attr in ("numeric_dims", "discrete_numeric_dims", "cat_dims", "perm_dims", "num_cols"):
        assert getattr(ts, attr) == getattr(js, attr)
    np.testing.assert_array_equal(ts.opt_lb, js.opt_lb)
    np.testing.assert_array_equal(ts.opt_ub, js.opt_ub)
    for seed in (0, 3):
        Xs = ts.sobol_sample_opt(13, seed=seed)
        np.testing.assert_array_equal(Xs, js.sobol_sample_opt(13, seed=seed))
        df_t, df_j = ts.inverse_transform(Xs), js.inverse_transform(Xs)
        pd.testing.assert_frame_equal(df_t, df_j)
        np.testing.assert_array_equal(ts.transform(df_t), js.transform(df_j))
        np.testing.assert_array_equal(ts.round_opt(Xs + 0.3), js.round_opt(Xs + 0.3))
        pd.testing.assert_frame_equal(ts.sample(5, seed=seed), js.sample(5, seed=seed))


@pytest.mark.parametrize("kind", ["positive", "mixed", "flat", "tiny_spread"])
def test_power_transform_matches(kind):
    rng = np.random.default_rng(7)
    y = {
        "positive": rng.lognormal(size=30),
        "mixed": rng.standard_normal(30) ** 3,
        "flat": np.ones(30),
        "tiny_spread": 100.0 + 1e-3 * rng.standard_normal(30),
    }[kind]
    pt_t, pt_j = ttr.fit_power_transform(y), jtr.fit_power_transform(y)
    assert tuple(pt_t) == tuple(pt_j)
    np.testing.assert_array_equal(ttr.power_transform_y(y, pt_t), jtr.power_transform_y(y, pt_j))


def test_scalers_and_yeo_johnson_match():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((20, 3)).astype(np.float32)
    mask = rng.uniform(size=20) > 0.3
    xt, mt = torch.as_tensor(x), torch.as_tensor(mask)
    for m_t, m_j in ((None, None), (mt, jnp.asarray(mask))):
        sj = jtr.fit_standard_scaler(jnp.asarray(x), m_j)
        st = ttr.fit_standard_scaler(xt, m_t)
        np.testing.assert_allclose(ttr.apply_standard_scaler(st, xt).numpy(),
                                   np.asarray(jtr.apply_standard_scaler(sj, jnp.asarray(x))), rtol=1e-6, atol=1e-6)
        mj = jtr.fit_minmax_scaler(jnp.asarray(x), m_j)
        mtp = ttr.fit_minmax_scaler(xt, m_t)
        u = ttr.apply_minmax_scaler(mtp, xt)
        np.testing.assert_allclose(u.numpy(), np.asarray(jtr.apply_minmax_scaler(mj, jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ttr.invert_minmax_scaler(mtp, u).numpy(), x, rtol=1e-5, atol=1e-5)
    for lam in (0.0, 0.5, 2.0):
        np.testing.assert_allclose(ttr.apply_yeo_johnson(xt, lam).numpy(),
                                   np.asarray(jtr.apply_yeo_johnson(jnp.asarray(x), lam)), rtol=1e-5, atol=1e-6)


_IMPORT_CHECK = """
import importlib, pkgutil, sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax.") or name == "hebo_tpu" or name.startswith("hebo_tpu."):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, _Block())
import hebo_tpu_torch
for m in pkgutil.walk_packages(hebo_tpu_torch.__path__, "hebo_tpu_torch."):
    importlib.import_module(m.name)
from hebo_tpu_torch import HEBO
from hebo_tpu_torch.optimizers import AntBOOptimizer, BoBuilder
from hebo_tpu_torch.tasks import AbsolutTool
for m in ("ops.ssk", "trust_region.casmo", "acq_optimizers.mcbo_opts", "optimizers.bo_builder",
          "optimizers.antbo", "tasks.antbo_tools"):
    assert "hebo_tpu_torch." + m in sys.modules, m
bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "hebo_tpu."))]
assert not bad, bad
print("ok")
"""


def test_port_imports_without_jax_or_hebo_tpu():
    out = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    for f in (REPO / "hebo_tpu_torch").rglob("*.py"):
        for line in f.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert not (words[1].startswith(("jax", "hebo_tpu.")) or words[1] == "hebo_tpu"), (f, line)


def test_cuda_default_device_does_not_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from hebo_tpu_torch import HEBO

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HEBO(DesignSpace([{"name": "x", "type": "num", "lb": 0, "ub": 1}]))
