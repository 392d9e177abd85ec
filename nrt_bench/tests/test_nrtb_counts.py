"""The operation and byte counters against counts by hand."""

from __future__ import annotations

import json

import pytest

from conftest import ROOT
from nrt_bench import counts


def cfg(name):
    return json.loads((ROOT / f"nrt_bench/configs/{name}.json").read_text())


def test_net_macs_by_hand():
    f = cfg("flagship")
    # shift net: encoding 3 + 64 = 67; layers 0, 3, 6 take [h, enc]
    assert counts.mlp_macs(f["surface"]["shift"]) == 67 * 128 + 3 * 195 * 128 + 5 * 128 * 128 + 128
    assert counts.mlp_macs(f["surface"]["shift"]) == 165_504
    # weight net: encoding 259; skips at 0, 3, 6, 9, 12 of 16 layers
    assert counts.mlp_macs(f["bsdf"]["weight_net"]) == (
        259 * 256 + 5 * 515 * 256 + 11 * 256 * 256 + 256 * 8)
    # a lobe: encoding 131, 6 layers of 96, skips at 0 and 3
    assert counts.mlp_macs(f["bsdf"]["lobe"]) == 131 * 96 + 2 * 227 * 96 + 4 * 96 * 96 + 96 * 3
    # the light field: encoding 35, 10 layers of 256, skips at 0, 3, 6
    assert counts.mlp_macs(f["light"]["net"]) == 35 * 256 + 3 * 291 * 256 + 7 * 256 * 256 + 256 * 3
    # the occlusion net: encoding 5 + 32 = 37, 8 layers of 64
    assert counts.mlp_macs(cfg("nerv_gear")["occlusion_net"]) == (
        37 * 64 + 3 * 101 * 64 + 5 * 64 * 64 + 64)


def test_sdf_ops_and_k3_bound():
    f = cfg("flagship")
    assert counts.sdf_ops(f) == 2 * 165_504 + 31 * 128
    # K3 at the training step's shape: 38,400 rays x 129 samples, 24.77 ms
    ops = 38_400 * 129 * counts.sdf_ops(f)
    bound = counts.bound_s(ops, counts.march_bytes(f, 38_400, 1))
    assert bound == pytest.approx(24.77e-3, rel=1e-3)
    assert counts.share(ops, 2 * counts.bound_s(ops)) == pytest.approx(50.0)
    assert counts.share(ops, 0.0) is None and counts.share(0, 1.0) is None


def test_weight_bytes_and_step_ops():
    f = cfg("flagship")
    shift = f["surface"]["shift"]
    assert counts.weight_bytes(shift) == 4 * (3 * 32 + 165_504 + 128 * 9 + 1)
    sdf, shading = counts.sdf_ops(f), counts.shading_ops(f)
    assert counts.train_step_ops(f, 10, 4, 100, 1290) == 100 * sdf + 1290 * sdf + 3 * (
        10 * 3 * sdf + 4 * shading)
    n = cfg("nerv_gear")
    occ = counts.net_ops(n["occlusion_net"])
    assert counts.view_ops(n, 5, 50, 20, 2) == 70 * counts.sdf_ops(n) + 5 * (
        2 * counts.sdf_ops(n) + counts.shading_ops(n)) + 2 * occ
