"""The plain references against the program on the CPU at a tiny size, on
the same seeded weights: the filmed SFNO's forward, its film-only Adam
steps (loss, first gradient, change), and the AFNO net's forward."""

from __future__ import annotations

import dataclasses

import torch
from conftest import tiny_config, tiny_mix

from port_bench.entries import finetune
from port_bench.harness import program, traffic

SEED = 2**31 + 12345


def _sfno_inputs(cfg, b=2):
    gen = torch.Generator().manual_seed(7)
    h, w = cfg["img_size"]
    x = traffic.smooth_field(gen, (b, h, w, cfg["in_chans"]), "cpu")
    film = cfg["film"]
    land = traffic.land_mask(*film["sst_shape"], 0.3)
    sst = traffic.sst_series(gen, b, film["temporal_step"], *film["sst_shape"], land, "cpu")
    return x, sst


def test_parameter_specs_match_the_program():
    from msfno_torch.models.sfno.sfnonet import FourierNeuralOperatorNetFilmed

    cfg = tiny_config("sfno-fcnv2small-gcnfilm")
    net = FourierNeuralOperatorNetFilmed(program.program_config(cfg), device="cpu")
    want = {n: tuple(p.shape) for n, p in net.named_parameters()}
    got = {n: s for n, s, _ in program.family(cfg).parameter_specs(cfg)}
    assert got == want


def test_sfno_forward_matches_the_program_exact_tier():
    from msfno_torch.config import exact_config
    from msfno_torch.models.sfno.sfnonet import FourierNeuralOperatorNetFilmed

    cfg = tiny_config("sfno-fcnv2small-gcnfilm")
    weights = program.seeded_weights(cfg, SEED, "cpu")
    net = FourierNeuralOperatorNetFilmed(exact_config(program.program_config(cfg)), device="cpu")
    net.load_state_dict(weights)
    ref = program.reference_net(cfg, SEED, "cpu")
    x, sst = _sfno_inputs(cfg)
    with torch.no_grad():
        a, b = net(x, sst, 1.0), ref(x, sst, 1.0)
    assert float((a - b).norm() / b.norm()) < 1e-5


def test_sfno_finetune_matches_the_program_trainer():
    """Three film-only Adam steps of the exact tier through the entry's own
    readings against the reference's."""
    from msfno_torch.config import exact_config

    cfg, mix = tiny_config("sfno-fcnv2small-gcnfilm"), tiny_mix("finetune-ms1-pool8")
    entry = finetune.Entry(cfg, mix, SEED, torch.device("cpu"))
    exact = exact_config(program.program_config(cfg))
    real = program.program_config
    program.program_config = lambda c: exact
    try:
        entry.setup()
    finally:
        program.program_config = real
    entry.release()
    nums = finetune.compare(entry.readings(), entry.reference())
    assert nums["loss_gap"] < 1e-5, nums
    assert nums["grad_gap"] < 1e-4, nums
    assert nums["change_gap"] < 1e-3, nums


def test_afno_forward_matches_the_program():
    from msfno_torch.models.registry import get_model

    cfg = tiny_config("afno-fourcastnet-v0.1")
    wrapper = get_model("fcn", "1", cfg=program.program_config(cfg), device="cpu")
    wrapper.module.load_state_dict(program.seeded_weights(cfg, SEED, "cpu"))
    ref = program.reference_net(cfg, SEED, "cpu")
    x = traffic.smooth_field(torch.Generator().manual_seed(3), (2, 32, 64, 8), "cpu")
    with torch.no_grad():
        a, b = wrapper.module(x), ref(x)
    assert float((a - b).norm() / b.norm()) < 1e-5


def test_afno_config_is_the_programs():
    """The program's AFNO takes its block count, MLP ratio and shrinkage
    from its defaults: the configuration must state the same."""
    from msfno_torch.models.afno.afnonet import AFNO2D, AFNONet

    cfg = tiny_config("afno-fourcastnet-v0.1")
    net = AFNONet(img_size=cfg["img_size"], patch_size=(8, 8), in_chans=8, out_chans=8,
                  embed_dim=32, depth=1, device="cpu")
    blk = net.blocks[0]
    assert isinstance(blk.filter, AFNO2D)
    assert blk.filter.num_blocks == cfg["num_blocks"]
    assert blk.filter.sparsity_threshold == cfg["sparsity_threshold"]
    assert blk.mlp.fc1.weight.shape[0] == cfg["mlp_ratio"] * 32
    assert dataclasses.is_dataclass(program.program_config(cfg))
