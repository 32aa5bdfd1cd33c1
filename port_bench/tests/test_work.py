"""The frozen work arithmetic against hand counts at the tiny shapes of
conftest (SFNO: 32x64 grid, scale 2, embed 32, 3 blocks, 2 spectral layers,
generator 8x16 / width 16 / depth 2; AFNO: 32x64, patch 8, embed 32, 2
blocks)."""

from __future__ import annotations

import pytest
from conftest import tiny_config

from port_bench.work import flops, kernels


def test_sfno_forward_parts_by_hand():
    p = flops.sfno_gcn_parts(tiny_config("sfno-fcnv2small-gcnfilm"))
    assert p["encoder"] == 2 * 2048 * (8 * 32 + 32 * 32) == 5_242_880
    assert p["decoder"] == 2 * 2048 * (40 * 32 + 32 * 8) == 6_291_456
    assert p["spectral_mlp"] == 3 * 8 * 16 * 17 * (32 * 64 + 64 * 64 + 64 * 32) == 53_477_376
    assert p["inner_skip"] == 2 * 512 * 32 * 32
    assert p["channel_mlp"] == 2 * (2 * 512 * (32 * 64 + 64 * 32))
    # FFT 2.5 n log2 n per row and channel, Legendre 4 M L H C
    assert p["sht_full"] == pytest.approx(2 * (32 * 32 * 2.5 * 64 * 6 + 4 * 17 * 16 * 32 * 32))
    assert p["sht_inner"] == pytest.approx(4 * (16 * 32 * 2.5 * 32 * 5 + 4 * 17 * 16 * 16 * 32))
    assert p["generator_layers"] == 2 * 128 * 16 + 2 * (2 * 128 * 16 * 16)
    assert p["generator_head"] == 2 * 16 * 64


def test_sfno_finetune_by_hand():
    cfg = tiny_config("sfno-fcnv2small-gcnfilm")
    p = flops.sfno_gcn_parts(cfg)
    fwd = sum(p.values())
    below = fwd - p["decoder"] - p["generator_layers"] - p["generator_head"]
    gen = (2 * 2 * 128 * 16 * 16 + p["generator_head"]) + (p["generator_layers"]
                                                          + p["generator_head"])
    assert flops.sfno_gcn_finetune(cfg, 1) == pytest.approx(
        2 * fwd + 2 * p["decoder"] + below + 2 * gen)
    assert flops.sfno_gcn_finetune(cfg, 0) == pytest.approx(fwd + p["decoder"] + gen)


def test_afno_forward_by_hand():
    cfg = tiny_config("afno-fourcastnet-v0.1")
    block = 2 * 32 * 2.5 * 32 * 5 + 2 * 4 * 2 * 12 * 32 * 4 + 2 * 32 * 2 * 32 * 128
    assert flops.afno_forward(cfg) == pytest.approx(
        2 * 32 * 512 * 32 + 2 * block + 2 * 32 * 32 * 512)


def test_spectral_mlp_launch_by_hand():
    s = kernels._shapes(tiny_config("sfno-fcnv2small-gcnfilm"))
    nbytes, ops = kernels.spectral_mlp_block(s, 1)
    assert nbytes == 2 * (2 * 272 * 32 * 4) + 2 * (32 * 64 + 64 * 64 + 64 * 32) * 2
    assert ops == {"bf16": 6 * 272 * 8192, "fp32": 272 * (160 + 192 + 128)}
    assert kernels.least_seconds(nbytes, ops) == pytest.approx(172_032 / 3.35e12)
    # a batch of 4 moves four times the activations, the weights once
    nb4, ops4 = kernels.spectral_mlp_block(s, 4)
    assert nb4 - nbytes == 3 * 2 * (2 * 272 * 32 * 4) and ops4["bf16"] == 4 * ops["bf16"]


def test_gcn_layer_sites_by_hand():
    s = kernels._shapes(tiny_config("sfno-fcnv2small-gcnfilm"))
    nbytes, ops = kernels.gcn_layer_conv(s, 1)
    assert nbytes == 128 * 16 * 2 * 2 + 16 * 16 * 2 + 16 * 4 + 128 * 2 * 2 + 128 * 16 * 2
    assert ops == {"bf16": 2 * 128 * 16 * 16, "fp32": 12 * 128 * 16}
    # the fp32 generator: fp32 activations and weight, fp32-class products
    s32 = kernels._shapes(tiny_config("sfno-fcnv2small-gcnfilm-fp32gen"))
    nb32, ops32 = kernels.gcn_layer_conv(s32, 1)
    assert nb32 == 128 * 16 * 4 * 2 + 16 * 16 * 4 + 16 * 4 + 128 * 4 * 2 + 128 * 16 * 4
    assert ops32 == {"fp32_product": 2 * 128 * 16 * 16, "fp32": 12 * 128 * 16}
    least = kernels.launch_least_seconds(tiny_config("sfno-fcnv2small-gcnfilm"), 1)
    one = kernels.least_seconds(*kernels.gcn_layer_conv1(s, 1))
    two = kernels.least_seconds(nbytes, ops)
    assert least["gcn_layer"] == pytest.approx(one / 3 + 2 * two / 3)
