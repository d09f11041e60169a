"""The risk step with its trials split over a one-process mesh
(``AggregateRiskAnalysis.make_sharded_step``) against the JAX package's
``kernels.ops.aggregate_loss`` on the same seeded tables (CPU), at the
reference's ``rtol=1e-6`` (``tests/test_risk.py``): trials are independent,
so the split changes nothing."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.risk_app import RiskAppConfig as JaxCfg
from repro.kernels import ops as jops
from repro.risk.tables import generate as jax_generate
from repro_torch.configs.risk_app import RiskAppConfig
from repro_torch.distributed.sharding import parse_mesh
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.risk.analysis import AggregateRiskAnalysis
from repro_torch.risk.tables import from_arrays

CPU = torch.device("cpu")
FIELDS = ("yet", "elt_losses", "occ_ret", "occ_lim")


@pytest.fixture(scope="module")
def jax_tables():
    return jax_generate(JaxCfg().reduced(), seed=0)


def _jax_ylt(t, variant, chunk, trials=None):
    jops.use_aggregate_variant(variant)
    try:
        return np.asarray(jops.aggregate_loss(
            jnp.asarray(t.yet[:trials]), jnp.asarray(t.elt_losses),
            jnp.asarray(t.occ_ret), jnp.asarray(t.occ_lim),
            jnp.asarray(t.agg_ret), jnp.asarray(t.agg_lim), chunk=chunk))
    finally:
        jops.use_aggregate_variant("gather")


@pytest.mark.parametrize("variant", ["gather", "onehot"])
@pytest.mark.parametrize("spec,trials", [("1x4", None), ("2x2", None),
                                         ("1x4", 1021), ("1x1", None)])
def test_sharded_step_matches_reference(jax_tables, variant, spec, trials):
    tables = from_arrays(jax_tables)
    ara = AggregateRiskAnalysis(RiskAppConfig().reduced(), device="cpu")
    mesh = parse_mesh(spec, [CPU] * 4)
    step = ara.make_sharded_step(mesh, chunk=16)
    args = [torch.from_numpy(np.ascontiguousarray(getattr(tables, f)))
            for f in FIELDS]
    args[0] = args[0][:trials]
    kops.use_aggregate_variant(variant)
    try:
        ylt = step(*args, float(tables.agg_ret), float(tables.agg_lim))
    finally:
        kops.use_aggregate_variant("gather")
    want = _jax_ylt(jax_tables, variant, 16, trials)
    assert ylt.shape == want.shape and ylt.device == CPU
    np.testing.assert_allclose(ylt.numpy(), want, rtol=1e-6)
    # each position ran its slice: as many launch shapes as slice sizes
    sizes = {len(s) for s in np.array_split(np.arange(len(want)),
                                            mesh.size)}
    assert ara.launch_shape_count == len(sizes)


def test_sharded_step_on_the_local_mesh(jax_tables):
    tables = from_arrays(jax_tables)
    ara = AggregateRiskAnalysis(RiskAppConfig().reduced(), device="cpu")
    step = ara.make_sharded_step(make_local_mesh([CPU] * 3))
    ylt = step(*(torch.from_numpy(np.ascontiguousarray(getattr(tables, f)))
                 for f in FIELDS), float(tables.agg_ret),
               float(tables.agg_lim))
    np.testing.assert_allclose(ylt.numpy(), ara.run_single(tables),
                               rtol=1e-6)
