"""The twins' command lines against the JAX scripts': every flag that the
JAX scripts take from ``base_parser`` (``scripts/_common.py``) and that a
twin used to refuse — ``--data-parallel``, ``--clip-norm``, ``--nan-skip``
— parses in each twin, and each twin does with it what its JAX script does:
DTU trains on one device and refuses it beside ``--device-data``; NeRV,
colocate and NeRFLE ignore it.  ``nerf_synthetic --data-parallel`` trains
over ``parallel.make_mesh()`` and refuses it beside ``--device-data``.
The twins of the five visualization and experiment scripts parse the JAX
scripts' command lines too.
"""

import sys
from pathlib import Path

import pytest

import neural_raytracing_tpu_torch.training as training
from neural_raytracing_tpu_torch.workloads import colocate, dtu, nerf_synthetic, nerfle, nerv

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
from _common import base_parser  # noqa: E402  (the JAX scripts' shared parser)

TWINS = {"dtu": dtu, "nerv": nerv, "colocate": colocate, "nerfle": nerfle,
         "nerf_synthetic": nerf_synthetic}
LINES = [["--data-parallel"], ["--clip-norm", "10"], ["--nan-skip"],
         ["--data-parallel", "--clip-norm", "2.5", "--nan-skip"]]


@pytest.mark.parametrize("line", LINES, ids=lambda x: " ".join(x))
@pytest.mark.parametrize("twin", sorted(TWINS))
def test_twin_parses_what_the_jax_script_parses(twin, line):
    want = base_parser("jax").parse_args(line)
    got = TWINS[twin].parser().parse_args(["--data", "unused", *line])
    for flag in ("data_parallel", "clip_norm", "nan_skip"):
        assert getattr(got, flag) == getattr(want, flag), flag


def _main_args(monkeypatch, module, loader):
    """Run ``module.main`` with its loader and ``run`` stubbed: -> the args
    ``run`` was handed."""
    seen = []
    monkeypatch.setattr(training, loader, lambda *a, **k: None)
    monkeypatch.setattr(module, "run", lambda args, *a, **k: seen.append(args))
    return seen


def test_dtu_main_trains_on_one_device_with_data_parallel(monkeypatch):
    seen = _main_args(monkeypatch, dtu, "load_dtu")
    dtu.main(["--data", "scan", "--data-parallel", "--device", "cpu"])
    assert len(seen) == 1 and seen[0].data_parallel


def test_dtu_refuses_data_parallel_beside_device_data():
    args = dtu.parser().parse_args(["--data", "scan", "--data-parallel", "--device-data",
                                    "--device", "cpu"])
    with pytest.raises(ValueError, match="single-device"):
        dtu.run(args, data=None)


def test_nerf_synthetic_data_parallel_still_raises():
    """``--data-parallel`` trains (tests/test_torch_parallel.py); beside
    ``--device-data``, a single-device path, it raises, as
    ``scripts/nerf_synthetic.py:227`` asserts."""
    with pytest.raises(ValueError, match="single-device"):
        nerf_synthetic.main(["--data", "unused", "--data-parallel", "--device-data",
                             "--device", "cpu"])


# ---- the visualization and experiment twins ----------------------------------------

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
NEW_TWINS = {"visualize": ["--data", "d"], "nerv_vis": ["--data", "d"],
             "dtu_vis": ["--data", "d"], "fit_sphere": [], "exp_gan": ["--data", "d"]}
NEW_LINES = [[], ["--size", "32", "--iters", "5", "--seed", "3"], ["--skip-test", "--cpu"],
             ["--data-parallel", "--clip-norm", "2.5", "--nan-skip"]]
SCRIPT_LINES = {"visualize": ["--dataset-name", "lego", "--n-orbit", "3"],
                "nerv_vis": ["--dist", "2.5", "--views", "2"], "dtu_vis": ["--views", "2"],
                "fit_sphere": ["--crop-size", "16", "--n-views", "2"],
                "exp_gan": ["--latent", "8", "--g-lr", "1e-3", "--d-lr", "3e-3"]}


def jax_script_parser(name: str):
    """The parser ``scripts/{name}.py`` builds in ``main``: ``base_parser``,
    then the script's own ``ap.add_argument`` and ``ap.set_defaults``
    calls, read from its source."""
    import argparse
    import ast
    types = {"int": int, "float": float, "str": str}

    def value(node):
        return types[node.id] if isinstance(node, ast.Name) else ast.literal_eval(node)

    ap = base_parser("jax")
    for node in ast.walk(ast.parse((SCRIPTS / f"{name}.py").read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name) and node.func.value.id == "ap"
                and node.func.attr in ("add_argument", "set_defaults")):
            getattr(ap, node.func.attr)(*map(value, node.args),
                                        **{k.arg: value(k.value) for k in node.keywords})
    assert isinstance(ap, argparse.ArgumentParser)
    return ap


@pytest.mark.parametrize("line", NEW_LINES + [None], ids=lambda x: "script's own" if x is None
                         else (" ".join(x) or "defaults"))
@pytest.mark.parametrize("twin", sorted(NEW_TWINS))
def test_new_twin_parses_what_the_jax_script_parses(twin, line):
    import importlib
    module = importlib.import_module(f"neural_raytracing_tpu_torch.workloads.{twin}")
    argv = NEW_TWINS[twin] + (SCRIPT_LINES[twin] if line is None else line)
    want = vars(jax_script_parser(twin).parse_args(argv))
    got = vars(module.parser().parse_args(argv))
    for dest, value in want.items():
        assert got[dest] == value, dest
