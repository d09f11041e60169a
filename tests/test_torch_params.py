"""The port's parameter axes, counts and input specs against the JAX
package's, for every arch (reduced configs; shapes only, nothing drawn):

* ``models.params.param_axes`` equal to the axes tree of
  ``pp.split(bundle.init(key))`` (the reference's boxed initialiser under
  ``jax.eval_shape``), and ``count_params`` to its ``count_params``;
* ``models.model.input_specs`` for every ``SHAPES`` cell: the same keys,
  shapes and dtypes as the reference's ``ShapeDtypeStruct``s, as meta
  tensors.
"""
import jax
import pytest

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_config
from repro.models import params as jparams
from repro.models.model import build_model as jax_build
from repro.models.model import input_specs as jax_input_specs
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.models.model import build_model, input_specs
from repro_torch.models.params import count_params, param_axes


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_match_reference(arch):
    boxed = jax.eval_shape(
        lambda: jax_build(jax_config(arch).reduced()).init(
            jax.random.PRNGKey(0)))
    want = jparams.split(boxed)[1]
    assert param_axes(get_config(arch).reduced()) == want
    assert count_params(build_model(get_config(arch).reduced()).init(
        0, "meta")) == jparams.count_params(jparams.split(boxed)[0])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch):
    for shape, jshape in zip(SHAPES, JAX_SHAPES):
        got = input_specs(get_config(arch), shape)
        want = jax_input_specs(jax_config(arch), jshape)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert tuple(got[k].shape) == tuple(w.shape)
            assert got[k].device.type == "meta"
            assert str(got[k].dtype).replace("torch.", "") == str(w.dtype)
