"""Port parity: the weights bridge, and the reduced flagship scene builders
that the other port tests share.

The reduced flagship keeps the structure of ``scripts/nerf_synthetic.py``
(SDF(SphereSDF) + ComposeSpatialVarying(8 x NeuralBSDF(softplus)) +
LightField) at narrow widths.  Its shift net is non-zero (uniform init, out
layer scaled by 0.1) so the MLP inside the march is exercised, and its
sphere radii are raised to [0.25, 0.35] so rays hit a surface of useful size.
"""

import jax
import numpy as np
import pytest
import torch

import neural_raytracing_tpu as J
from neural_raytracing_tpu.bsdf import ComposeSpatialVarying as JCompose
from neural_raytracing_tpu.bsdf import NeuralBSDF as JNeuralBSDF
from neural_raytracing_tpu.kernels import FusedSkipConnMLP as JFused
from neural_raytracing_tpu.lights import LightField as JLightField
from neural_raytracing_tpu.shapes import SDF as JSDF
from neural_raytracing_tpu.shapes import SphereSDF as JSphereSDF
import neural_raytracing_tpu_torch as T
from neural_raytracing_tpu_torch.bsdf import ComposeSpatialVarying, NeuralBSDF
from neural_raytracing_tpu_torch.kernels import FusedSkipConnMLP
from neural_raytracing_tpu_torch.lights import LightField
from neural_raytracing_tpu_torch.params import load_jax_params, state_dict_from_jax
from neural_raytracing_tpu_torch.shapes import SDF, SphereSDF

torch.set_num_threads(1)

NETS = {
    "shift": dict(in_size=3, out=1, num_layers=2, hidden_size=16, freqs=4,
                  activation="softplus", init="uniform"),
    "weight": dict(in_size=3, out=8, num_layers=4, hidden_size=16, freqs=4,
                   sigma=128.0, init="xavier"),
    "lobe": dict(in_size=3, out=3, num_layers=4, hidden_size=16, freqs=4),
    "light": dict(in_size=3, out=3, num_layers=4, hidden_size=16, freqs=4),
}


def build_scene(lib, max_steps=64, march_bound=None, stable_min=False,
                n_spheres=8, occlusion="none"):
    """The reduced flagship, built from the JAX package ("jax") or the port."""
    if lib == "jax":
        mlp, scene, sdf, sphere = JFused, J.Scene, JSDF, JSphereSDF
        compose, lobe, light = JCompose, JNeuralBSDF, JLightField
    else:
        mlp, scene, sdf, sphere = FusedSkipConnMLP, T.Scene, SDF, SphereSDF
        compose, lobe, light = ComposeSpatialVarying, NeuralBSDF, LightField
    return scene(
        shape=sdf(sphere(n=n_spheres, mlp=mlp(**NETS["shift"]),
                         stable_min=stable_min),
                  max_steps=max_steps, march_bound=march_bound),
        bsdf=compose([lobe(activation="softplus", mlp=mlp(**NETS["lobe"]))
                      for _ in range(8)], sp_var_fn=mlp(**NETS["weight"])),
        lights=light(mlp=mlp(**NETS["light"])),
        occlusion=occlusion)


def scene_params(jscene, seed=0):
    """JAX params (numpy) with a non-zero, moderate shift and larger spheres."""
    tree = jax.tree.map(np.asarray, jscene.init(jax.random.PRNGKey(seed)))
    shape = tree["shape"]
    shape["shift"]["out"] = {k: 0.1 * v for k, v in shape["shift"]["out"].items()}
    shape["radii"] = 0.3 + 0.5 * shape["radii"]
    return tree


def scene_pair(**kw):
    """(JAX scene, JAX params, port scene on the CPU with those params)."""
    jscene = build_scene("jax", **kw)
    tree = scene_params(jscene)
    return jscene, tree, load_jax_params(build_scene("torch", **kw), tree,
                                         device="cpu")


def _flat_numpy(tree):
    return {k: v.numpy() for k, v in state_dict_from_jax(tree).items()}


def test_scene_tree_loads_strictly_and_round_trips():
    _, tree, scene = scene_pair()
    want = _flat_numpy(tree)
    got = {k: v.numpy() for k, v in scene.state_dict().items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert scene.shape.centers.data_ptr() == scene.shape.module.centers.data_ptr()


def test_parameter_names_follow_the_pytree_paths():
    _, _, scene = scene_pair()
    names = dict(scene.named_parameters())
    for name in ("shape.centers", "shape.radii", "shape.tfs",
                 "shape.shift.layers.1.w", "shape.shift.out.b",
                 "bsdf.sp_var_fn.init.w", "bsdf.bsdfs.5.mlp.out.b",
                 "lights.mlp.layers.3.w", "lights.color"):
        assert name in names, name
    buffers = dict(scene.named_buffers())
    assert "shape.shift.B" in buffers and "bsdf.bsdfs.0.mlp.B" in buffers
    # the JAX [fan_in, fan_out] layout is kept
    assert names["bsdf.sp_var_fn.out.w"].shape == (16, 8)


@pytest.mark.parametrize("change", ["missing", "extra"])
def test_missing_or_extra_leaf_is_rejected(change):
    jscene = build_scene("jax")
    tree = scene_params(jscene)
    if change == "missing":
        del tree["lights"]["color"]
    else:
        tree["shape"]["scale"] = np.ones(3, np.float32)
    with pytest.raises(RuntimeError):
        load_jax_params(build_scene("torch"), tree, device="cpu")


def test_scene_init_draws_from_the_generator():
    a = build_scene("torch").init(torch.Generator().manual_seed(0), device="cpu")
    b = build_scene("torch").init(torch.Generator().manual_seed(0), device="cpu")
    c = build_scene("torch").init(torch.Generator().manual_seed(1), device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["shape.centers"], sc["shape.centers"])
    assert (sa["shape.radii"].abs() <= 0.1).all() and not sa["shape.tfs"].any()
    assert not sa["lights.color"].any()
    # the flagship's own shift starts at zero
    flagship = SphereSDF(n=4)
    flagship.reset_parameters(torch.Generator().manual_seed(0))
    assert not any(p.any() for p in flagship.shift.parameters())


@pytest.mark.parametrize("occlusion", ["hard", "learned"])
def test_occlusion_modes_and_the_occ_net_follow_the_pytree(occlusion):
    jscene = build_scene("jax", occlusion=occlusion)
    tree = scene_params(jscene)
    scene = load_jax_params(build_scene("torch", occlusion=occlusion), tree,
                            device="cpu")
    assert scene.occlusion == occlusion
    if occlusion == "learned":       # the default occlusion net, child "occ"
        assert set(tree["occ"]) == {"B", "init", "layers", "out"}
        assert scene.occ.in_size == 5 and scene.occ.out_size == 1
        assert scene.occ.hidden_size == 64 and scene.occ.num_layers == 8
        assert scene.occ.freqs == 16 and scene.occ.activation_name == "leaky_relu"
        assert "occ.layers.7.w" in dict(scene.named_parameters())
    else:
        assert scene.occ is None and tree["occ"] == {}
    with pytest.raises(ValueError, match="occlusion"):
        build_scene("torch", occlusion="soft")
