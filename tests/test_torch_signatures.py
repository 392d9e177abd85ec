"""Signature parity: every parameter of the JAX package's public functions
and methods has its counterpart in the port.

For each module of ``neural_raytracing_tpu`` (read with ``ast``: nothing of
JAX is imported) every public function, and every public method of a public
class (``__init__``, and ``__call__`` as the port's ``forward`` on an
``nn.Module``), is looked up in the port's module of the same path and read
with ``inspect.signature``.  Each JAX parameter must have a port parameter
of the same name, unless ``EXCEPTIONS`` below names its counterpart or says
why it has none.  Where both give a parameter a default, the defaults must
be equal: the JAX default's source, spelled out for the port (``jnp.`` ->
``torch.``, ``jnp.inf`` / ``np.inf`` -> ``math.inf``), is evaluated in the
port module's namespace and compared with the port's default value.

``test_torch_utils.py::test_every_public_jax_name_has_its_port_counterpart``
holds the names; this test holds what each of them can be asked.
"""

import ast
import importlib
import inspect
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

ROOT = Path(__file__).resolve().parents[1]
JAX_ROOT = ROOT / "neural_raytracing_tpu"

# (JAX module, callable, JAX parameter) -> the port's parameter in its place,
# or None where the port has none.  "*" matches any module or callable; a
# callable is named as the JAX package names it ("function" or
# "Class.method").  A parameter of "*" stands for the callable itself: the
# port has no such method.
EXCEPTIONS = {
    # the params pytree: a port module holds its own parameters (nn.Module state)
    ("*", "*", "params"): None,
    # a JAX PRNG key: the port draws from a torch.Generator
    ("*", "*", "key"): "generator",
    # the Pallas interpreter: a port wrapper takes its plain version on a CPU tensor
    ("*", "*", "interpret"): None,
    # Pallas block rows: each CUDA kernel plans its own blocks (march_plan, shadow_plan, ...)
    ("*", "*", "block_rows"): None,
    # an optax optimizer: the port builds torch's AdamW from its OptimizerConfig
    ("*", "*", "optimizer"): "optimizer_config",
    # a reduction axis: torch's dim
    ("ops/math.py", "normalize", "axis"): "dim",
    ("ops/math.py", "smooth_min", "axis"): "dim",
    ("ops/math.py", "stable_smooth_min", "axis"): "dim",
    # the render's key: an int that seeds the per-tile generators (None: no draws)
    ("render.py", "pathtrace", "key"): "key",
    # a mask that no JAX intersect reads (a slot of the shared interface)
    ("shapes/analytic.py", "Sphere.intersect", "active"): None,
    ("shapes/analytic.py", "SphereCloud.intersect", "active"): None,
    ("shapes/sdf.py", "SDF.intersect", "active"): None,
    # the sphere cloud's ray length: max_t, as the other shapes name it
    ("shapes/analytic.py", "SphereCloud.intersect", "t_max"): "max_t",
    # a function's own params or light params beside the scene's: held by the modules
    ("shapes/nerf.py", "*", "light_params"): None,
    ("utils.py", "sphere_render_bsdf", "bsdf_params"): None,
    ("utils.py", "sphere_examples", "mixture_params"): None,
    ("utils.py", "heightmap", "warp_params"): None,
    # pytree templates of the checkpoint readers: a port module loads into itself
    ("training/checkpoint.py", "load_pytree", "template"): None,
    ("training/checkpoint.py", "load_scene", "template_params"): None,
    ("training/checkpoint.py", "load_train_state", "params_template"): None,
    ("training/checkpoint.py", "load_train_state", "opt_state_template"): None,
    # TrainState.opt_state: the optimizer's state lives in torch's optimizer
    ("training/checkpoint.py", "save_train_state", "opt_state"): None,
    # a pytree of gradients: the port's global_norm takes the tensors
    ("training/optim.py", "global_norm", "tree"): "tensors",
    # the pytree to replicate: the port broadcasts a module's state in place
    ("parallel/mesh.py", "replicate", "tree"): "module",
    # the mesh's axis name: a torch.distributed group has one axis, no name
    ("parallel/mesh.py", "make_mesh", "axis"): None,
    # jit buffer donation: torch updates the parameters in place
    ("training/loop.py", "make_device_data_step", "donate"): None,
    # a rebuild of the native library: the port's is keyed by a hash of its
    # source and flags (native/__init__.py), so a stale one is never loaded
    ("native/__init__.py", "build", "force"): None,
    # Pallas backward options of the JAX fused MLP: the port's backward is its
    # own kernels K6 / K7, picked by route (kernels/fused_mlp.py)
    ("kernels/fused_mlp.py", "FusedSkipConnMLP.__init__", "pallas_bwd"): None,
    ("kernels/fused_mlp.py", "FusedSkipConnMLP.__init__", "pallas_bwd_segments"): None,
    # the apply function's module and input: the port's is a method of the module
    ("kernels/fused_mlp.py", "fused_mlp_apply", "x"): "p",
    # the composite's ray-major copies: K8 reads the sample-major arrays only
    ("kernels/composite.py", "fused_composite", "sigma_rt"): None,
    ("kernels/composite.py", "fused_composite", "rgb_rt"): None,
    # the silhouette scan's step: the port's wrapper takes it as ``step``
    ("kernels/fused_march.py", "fused_min_scan", "step_size"): "step",
    # Integrator.sample(training=None) resolves None to self.training: the
    # same function as JAX's training=False default on a non-training integrator
    ("integrators/integrators.py", "*.sample", "training"): "training",
    # a TriangleMesh's intersector: "torch" (the port's) or "native" for JAX's "jax"
    ("shapes/mesh.py", "TriangleMesh.__init__", "backend"): "backend",
    # the seed of a keyless call: an int where JAX takes key=None to PRNGKey(0..)
    ("training/eval.py", "evaluate", "key"): "key",
    ("training/calibrate.py", "calibrate_exposure", "key"): "key",
    ("utils.py", "sphere_render_bsdf", "key"): "key",
    # a JAX parameter pytree initialiser: an nn.Module is built with its parameters
    ("*", "*.init", "*"): None,
    # a jnp twin of the shift net: the port's forward is the plain version
    ("kernels/fused_sdf.py", "FusedSphereSDF.shift_jnp", "*"): None,
    # the threaded key's split: the port's Sampler holds a torch.Generator
    ("samplers.py", "Sampler.split", "*"): None,
}

# the port's name of a JAX method on an nn.Module
METHODS = {"__call__": "forward"}
# the JAX package's TPU backend query: the port decides by the tensor's device
TPU_ONLY = {"on_tpu"}

JAX_MODULES = sorted(str(p.relative_to(JAX_ROOT)) for p in JAX_ROOT.rglob("*.py"))


USED = set()      # the entries of EXCEPTIONS that a lookup has matched


def _exception(module, callable_, param):
    cls_wild = "*." + callable_.split(".")[-1] if "." in callable_ else None
    for m in (module, "*"):
        for c in (callable_, cls_wild, "*"):
            if c is not None and (m, c, param) in EXCEPTIONS:
                USED.add((m, c, param))
                return True, EXCEPTIONS[(m, c, param)]
    return False, None


def _jax_callables(path: Path) -> dict:
    """{name or Class.method: FunctionDef} of a JAX module's public API
    (properties left out)."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for sub in node.body:
                public = not sub.name.startswith("_") if isinstance(
                    sub, ast.FunctionDef) else False
                if isinstance(sub, ast.FunctionDef) and (
                        public or sub.name in ("__init__", "__call__")) and not any(
                        isinstance(d, ast.Name) and d.id == "property"
                        for d in sub.decorator_list):
                    out[f"{node.name}.{sub.name}"] = sub
    return out


def _jax_params(fn: ast.FunctionDef) -> dict:
    """{name: default source or None} (``*args`` / ``**kw`` prefixed)."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + [ast.unparse(d) for d in a.defaults]
    out = dict(zip((p.arg for p in pos), defaults))
    for p, d in zip(a.kwonlyargs, a.kw_defaults):
        out[p.arg] = None if d is None else ast.unparse(d)
    if a.vararg:
        out["*" + a.vararg.arg] = None
    if a.kwarg:
        out["**" + a.kwarg.arg] = None
    for self_name in ("self", "cls"):
        out.pop(self_name, None)
    return out


def _port_params(fn) -> dict:
    out = {}
    for p in inspect.signature(fn).parameters.values():
        prefix = {p.VAR_POSITIONAL: "*", p.VAR_KEYWORD: "**"}.get(p.kind, "")
        out[prefix + p.name] = p.default
    out.pop("self", None)
    return out


def _port_module(module: str):
    name = "neural_raytracing_tpu_torch." + module[:-3].replace("/", ".")
    return importlib.import_module(name.removesuffix(".__init__"))


def _port_callable(pm, qualname: str):
    head, _, method = qualname.partition(".")
    obj = getattr(pm, head)
    if not method:
        return obj
    if isinstance(obj, type) and issubclass(obj, nn.Module):
        method = METHODS.get(method, method)
    return getattr(obj, method, None)


def spelled_out(source: str) -> str:
    """A JAX default's source as the port spells it."""
    for old, new in (("jnp.inf", "math.inf"), ("np.inf", "math.inf"), ("jnp.", "torch.")):
        source = source.replace(old, new)
    return source


def _same_default(source: str, value, namespace: dict) -> bool:
    want = eval(spelled_out(source), {"math": math, "torch": torch, "np": np, **namespace})
    if want is value:
        return True
    if isinstance(want, (tuple, list)) and isinstance(value, (tuple, list)):
        return len(want) == len(value) and all(
            _same_default(repr(w), v, namespace) for w, v in zip(want, value))
    try:
        return bool(want == value)
    except (TypeError, ValueError, RuntimeError):
        return False


def signature_gaps(module: str) -> list:
    """Every JAX parameter of ``module`` without its counterpart in the
    port, and every default the two give differently."""
    pm = _port_module(module)
    gaps = []
    for qualname, node in _jax_callables(JAX_ROOT / module).items():
        if qualname in TPU_ONLY:
            continue
        fn = _port_callable(pm, qualname)
        if fn is None:
            if not _exception(module, qualname, "*")[0]:
                gaps.append(f"{qualname}: no such callable in the port")
            continue
        port = _port_params(fn)
        for name, source in _jax_params(node).items():
            excepted, counterpart = _exception(module, qualname, name)
            if excepted and counterpart is None:
                continue
            target = counterpart if excepted else name
            if target not in port:
                gaps.append(f"{qualname}({name}): the port has no {target!r}")
            elif (source is not None and not excepted
                  and port[target] is not inspect.Parameter.empty
                  and not _same_default(source, port[target], vars(pm))):
                gaps.append(f"{qualname}({name}): default {source} in JAX, "
                            f"{port[target]!r} in the port")
    return gaps


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_jax_parameter_has_its_port_counterpart(module):
    gaps = signature_gaps(module)
    assert not gaps, f"{module}: " + "; ".join(gaps)


def test_the_exception_table_names_only_what_exists():
    """Each entry of EXCEPTIONS names a JAX module, callable and parameter
    that exist, and none of them is one that the port has under its own
    name (an entry that would hide a parameter the port now takes)."""
    wild = {key for key in EXCEPTIONS if "*" in key[0] or "*" in key[1]}
    for module, qualname, param in set(EXCEPTIONS) - wild:
        callables = _jax_callables(JAX_ROOT / module)
        assert qualname in callables, (module, qualname)
        if param == "*":
            assert _port_callable(_port_module(module), qualname) is None, (module, qualname)
            continue
        assert param in _jax_params(callables[qualname]), (module, qualname, param)
        port = _port_params(_port_callable(_port_module(module), qualname))
        counterpart = EXCEPTIONS[(module, qualname, param)]
        if counterpart is None:
            assert param not in port, (module, qualname, param)
        else:
            assert counterpart in port, (module, qualname, param)


@pytest.mark.parametrize("source,want", [
    ("jnp.float32", "torch.float32"), ("jnp.inf", "math.inf"), ("np.inf", "math.inf"),
    ("-jnp.inf", "-math.inf"), ("(0.0, 1.0)", "(0.0, 1.0)"),
])
def test_the_default_spelling(source, want):
    assert spelled_out(source) == want


def test_every_exception_is_used():
    for module in JAX_MODULES:
        signature_gaps(module)
    assert not set(EXCEPTIONS) - USED, sorted(set(EXCEPTIONS) - USED)
