"""The port's CNN against the JAX package's, on the CPU.

Weights come from the reference's ``model.init`` and cross through numpy
(``params_from_numpy``); inputs come from numpy with a seed.  The port's CPU
path runs the plain conv, the reference ``lax.conv`` (the plain conv is held
against the Pallas kernel in ``test_torch_kernels.py``).  Activations shrink
layer by layer (He-scaled weights, ReLU), so the reference's conv tolerance
3e-4 is applied relative to the largest magnitude of each compared output as
well as elementwise.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

import jax
import jax.numpy as jnp

from repro.models import cnn as jcnn
from repro_torch.models import cnn

TOL = 3e-4
IN_SHAPE = (8, 8, 8)


def assert_close(actual, desired, tol=TOL):
    desired = np.asarray(desired)
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=tol, atol=tol * float(np.abs(desired).max()))


@pytest.fixture(scope="module")
def pair():
    """SynthNet at scale 0.1 in both packages, with the reference's weights."""
    jmodel = jcnn.make_cnn("synthnet", scale=0.1)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    np_params = [{k: np.asarray(v) for k, v in p.items()} for p in jparams]
    model = cnn.make_cnn("synthnet", scale=0.1, device="cpu").params_from_numpy(np_params)
    return jmodel, jparams, model


def _x(shape=(2, *IN_SHAPE), seed=1):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


@pytest.mark.parametrize("name", sorted(cnn.NETWORKS))
def test_spec_tables_equal_the_references(name):
    ours = [dataclasses.astuple(sp) for sp in cnn.NETWORKS[name]()]
    theirs = [dataclasses.astuple(sp) for sp in jcnn.NETWORKS[name]()]
    assert ours == theirs
    assert [dataclasses.astuple(l) for l in cnn.network_layers(name)] == [
        dataclasses.astuple(l) for l in jcnn.network_layers(name)
    ]


@pytest.mark.parametrize("name", sorted(cnn.NETWORKS))
@pytest.mark.parametrize("scale", [1.0, 0.1, 0.12])
def test_make_cnn_specs_equal_the_references(name, scale):
    ours = cnn.make_cnn(name, scale=scale, device="meta").specs
    theirs = jcnn.make_cnn(name, scale=scale).specs
    assert [dataclasses.astuple(sp) for sp in ours] == [dataclasses.astuple(sp) for sp in theirs]


@pytest.mark.parametrize(
    "out", [(2, 12, 12, 12), (2, 5, 5, 5), (2, 3, 3, 3), (2, 12, 5, 3), (2, 7, 3, 12), (1, 220, 220, 3)]
)
def test_resize_matches_jax_nearest_on_every_axis(out):
    x = _x((2, 7, 7, 7)) if out[0] == 2 else _x((1, 13, 13, 256))
    ours = cnn.resize_nearest(torch.from_numpy(x), out).numpy()
    theirs = np.asarray(jax.image.resize(jnp.asarray(x), out, "nearest"))
    np.testing.assert_array_equal(ours, theirs)


def test_resize_is_nearest_exact_spatially():
    x = torch.from_numpy(_x((2, 7, 7, 4)))
    for n in (12, 5, 3):
        ours = cnn.resize_nearest(x, (2, n, n, 4))
        theirs = torch.nn.functional.interpolate(x.permute(0, 3, 1, 2), size=(n, n), mode="nearest-exact")
        assert torch.equal(ours, theirs.permute(0, 2, 3, 1))


def test_params_cross_as_they_are(pair):
    jmodel, jparams, model = pair
    for i, p in enumerate(jparams):
        assert model.w[i].shape == p["w"].shape  # HWIO, no transpose
        np.testing.assert_array_equal(model.w[i].numpy(), np.asarray(p["w"]))
        np.testing.assert_array_equal(model.b[i].numpy(), np.asarray(p["b"]))


def test_params_from_numpy_rejects_wrong_layer_count(pair):
    _, jparams, model = pair
    with pytest.raises(ValueError, match="parameter sets"):
        model.params_from_numpy([{k: np.asarray(v) for k, v in p.items()} for p in jparams[:-1]])


def test_layer_by_layer_matches_reference(pair):
    jmodel, jparams, model = pair
    x = jnp.asarray(_x())
    for i in range(len(jmodel.specs)):
        want = jmodel.apply_layer(i, jparams[i], x)
        got = model.apply_layer(i, torch.from_numpy(np.array(x)))
        assert tuple(got.shape) == want.shape
        assert_close(got.numpy(), want)
        x = want  # every layer gets the reference's input


def test_full_network_matches_reference(pair):
    jmodel, jparams, model = pair
    x = _x()
    want = jmodel(jparams, jnp.asarray(x))
    got = model(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    assert_close(got.numpy(), want)


def test_canonical_apply_matches_reference(pair):
    jmodel, jparams, model = pair
    japply, jto_canon, jcrop, jcanon = jcnn.canonical_pipeline_apply(jmodel, jparams, IN_SHAPE)
    apply_fn, to_canon, crop_out, canon = cnn.canonical_pipeline_apply(model, IN_SHAPE)
    assert canon == jcanon
    x = _x()
    xc, jxc = to_canon(torch.from_numpy(x)), jto_canon(jnp.asarray(x))
    np.testing.assert_array_equal(xc.numpy(), np.asarray(jxc))
    for i in range(len(model.specs)):
        xc, jxc = apply_fn(i, xc), japply(i, jxc)
        assert tuple(xc.shape) == jxc.shape
        assert_close(xc.numpy(), jxc)
    assert_close(crop_out(xc).numpy(), jcrop(jxc))


def test_init_is_seeded_and_he_scaled():
    a = cnn.make_cnn("synthnet", scale=0.1, device="cpu").init(torch.Generator().manual_seed(3))
    b = cnn.make_cnn("synthnet", scale=0.1, device="cpu").init(torch.Generator().manual_seed(3))
    for sp, wa, wb, ba in zip(a.specs, a.w, b.w, a.b):
        assert torch.equal(wa, wb)
        assert not ba.any()
        fan_in = sp.r * sp.s * sp.c_in
        assert abs(float(wa.std()) * np.sqrt(fan_in) - 1.0) < 0.2
