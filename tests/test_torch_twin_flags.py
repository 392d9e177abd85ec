"""The twins' command lines against the JAX scripts': every flag that the
JAX scripts take from ``base_parser`` (``scripts/_common.py``) and that a
twin used to refuse — ``--data-parallel``, ``--clip-norm``, ``--nan-skip``
— parses in each twin, and each twin does with it what its JAX script does:
DTU trains on one device and refuses it beside ``--device-data``; NeRV,
colocate and NeRFLE ignore it.  ``nerf_synthetic --data-parallel`` shards
in the JAX script and still raises in the twin (ROADMAP.md Queue 1 item 4).
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
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        nerf_synthetic.main(["--data", "unused", "--data-parallel", "--device", "cpu"])
