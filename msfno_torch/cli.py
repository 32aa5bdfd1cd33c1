"""Command-line interface of the PyTorch port (port of msfno_tpu/cli.py;
reference main.py:384-1137).

    python -m msfno_torch.cli ARGS          # one card (or --cpu)
    torchrun --nproc_per_node N -m msfno_torch.cli ARGS --mesh auto

The flags are the JAX CLI's, so a `python main.py ARGS` command line runs
unchanged here, on the CUDA card unless --cpu is given.  The same argument
groups (Data, Inference, Training, Evaluate, Logging, Architecture,
Architecture Film Gen) assemble the configs; on --resume-checkpoint they are
merged with the checkpoint's stored hyperparameters: explicitly passed flags
win, the architecture groups are protected (reference main.py:179-246).
Checkpoints are this package's `.pt` files; every flag that takes one also
takes a JAX `.npz` and a reference PyTorch `.tar`.  --mesh spans the data
axis of a torch.distributed group (one process per card); the lat and
channel axes are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import os
import socket
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger("msfno_torch")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("msfno_torch", description=__doc__)
    p.add_argument("--model", default="sfno", choices=["sfno", "fcn", "mae"])
    p.add_argument("--model-version", default="latest",
                   help="sfno: latest|film; fcn: 0|1; mae: latest|lin-probe")
    p.add_argument("--assets", default=None, help="asset directory (stats, weights)")
    p.add_argument("--output-path", default="./output")
    p.add_argument("--resume-checkpoint", default=None)
    p.add_argument("--film-weights", default=None,
                   help="film-generator checkpoint merged onto the backbone")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (reference main.py --cpu); without it "
                   "every action runs on the CUDA card")

    # actions (dispatch per reference main.py:261-339)
    act = p.add_argument_group("Actions")
    act.add_argument("--train", action="store_true")
    act.add_argument("--run", action="store_true")
    act.add_argument("--eval-model", action="store_true")
    act.add_argument("--save-forecast", action="store_true")
    act.add_argument("--test-performance", action="store_true")
    act.add_argument("--test-dataloader-speed", action="store_true")
    act.add_argument("--test-batch-size", action="store_true")
    act.add_argument("--save-data", action="store_true",
                     help="dump raw batches to npz (reference main.py:293)")
    act.add_argument("--dump-provenance", action="store_true")

    data = p.add_argument_group("Data and Data Sources")
    data.add_argument("--era5-path", default=None, help="ERA5 zarr/npy store")
    data.add_argument("--sst-path", default=None)
    data.add_argument("--synthetic-data", action="store_true",
                      help="use the synthetic generator (no data on disk)")
    data.add_argument("--dataset-start-year", type=int, default=1979,
                      help="first year present in the store (time index origin)")
    data.add_argument("--trainingset-start-year", type=int, default=1979)
    data.add_argument("--trainingset-end-year", type=int, default=2016)
    data.add_argument("--validationset-start-year", type=int, default=2016)
    data.add_argument("--validationset-end-year", type=int, default=2018)
    data.add_argument("--training-workers", type=int, default=4)
    data.add_argument("--batch-size", type=int, default=1)
    data.add_argument("--validation-batches", type=int, default=4,
                      help="validation batches per validation pass")
    data.add_argument("--past-sst", action="store_true",
                      help="SST windows strictly before each step "
                           "(reference past_sst, data.py:208-211)")
    data.add_argument("--climatology-path", default=None,
                      help=".npy climatology for --eval-model skill scores")
    data.add_argument("--no-shuffle", action="store_true",
                      help="disable training-loader shuffling (main.py:580)")
    data.add_argument("--batch-size-validation", type=int, default=None,
                      help="validation batch size (defaults to --batch-size; "
                           "main.py:778)")
    data.add_argument("--input-transfer-dtype", default="float32",
                      choices=["float32", "bfloat16"],
                      help="dtype of era5/SST fields as transferred to the "
                           "device; bfloat16 halves host->device bytes "
                           "(cast in loader workers, overlapped) at ~0.4%% "
                           "relative input error — for transfer-bandwidth-"
                           "bound pipelines (BASELINE.md round-4 section)")
    data.add_argument("--cls", default=None,
                      help=".npy of precomputed MAE cls tokens "
                           "(lin-probe input, main.py:554)")
    data.add_argument("--oni-path", default=None,
                      help=".npy of ONI indices (lin-probe target, "
                           "main.py:560)")

    run = p.add_argument_group("Inference Parameters")
    run.add_argument("--lead-time", type=int, default=24, help="hours")
    run.add_argument("--date", default=None, help="YYYYMMDD initial condition")
    run.add_argument("--time", type=int, default=0)
    run.add_argument("--output", default="npz",
                     choices=["npz", "file", "netcdf", "none"])
    run.add_argument("--output-variables", default=None,
                     help="JSON list of variables to write "
                          "(reference output-variables.json)")
    run.add_argument("--hindcast", action="store_true",
                     help="relabel outputs with hindcast metadata")
    run.add_argument("--hindcast-reference-year", type=int, default=None,
                     help="reference year for hindcast relabeling "
                          "(main.py:626)")

    tr = p.add_argument_group("Training Parameters")
    tr.add_argument("--learning-rate", type=float, default=5e-4)
    tr.add_argument("--optimizer", default="adam", choices=["adam", "adamw", "sgd"])
    tr.add_argument("--weight-decay", type=float, default=0.0)
    tr.add_argument("--scheduler", default="none",
                    choices=["none", "cosine", "step"])
    tr.add_argument("--scheduler-horizon", type=int, default=2000)
    tr.add_argument("--loss-fn", default="L2Sphere_noSine")
    tr.add_argument("--training-epochs", type=int, default=1)
    tr.add_argument("--multi-step-training", type=int, default=0)
    tr.add_argument("--training-step-skip", type=int, default=0)
    tr.add_argument("--discount-factor", type=float, default=1.0)
    tr.add_argument("--accumulation-steps", type=int, default=0)
    tr.add_argument("--validation-interval", type=int, default=100)
    tr.add_argument("--multi-step-validation", type=int, default=0)
    tr.add_argument("--validation-step-skip", type=int, default=0)
    tr.add_argument("--save-checkpoint-interval", type=int, default=1)
    tr.add_argument("--retrain-film", action="store_true")
    tr.add_argument("--dropout", type=float, default=0.0,
                    help="film-generator dropout (main.py:864)")
    tr.add_argument("--set-epoch", type=int, default=None,
                    help="start the epoch loop here (overrides the "
                         "checkpoint's epoch; main.py:940)")
    tr.add_argument("--sfno-weights", default=None,
                    help="pretrained SFNO backbone weights (.tar/.npz/.pt) to "
                         "load before film fine-tuning (main.py:410)")
    tr.add_argument("--batch-size-step", type=int, default=0,
                    help="linear growth step for --test-batch-size "
                         "(0 = geometric 1,2,4,...; main.py:907)")
    tr.add_argument("--resume-optimizer", action="store_true",
                    help="restore optimizer state from --resume-checkpoint "
                         "(reference train.py:398-402)")
    tr.add_argument("--resume-scheduler", action="store_true",
                    help="restore LR-schedule position from --resume-checkpoint "
                         "(reference train.py:428-431)")
    tr.add_argument("--film-scale-start", type=float, default=0.0)
    tr.add_argument("--bf16-frozen-params", action="store_true",
                    help="store the frozen backbone in bfloat16 (halves "
                         "frozen-param HBM traffic; fast/bf16 config only)")
    tr.add_argument("--time-limit", default=None,
                    help="HH:MM:SS graceful-stop wall limit (main.py:149-156)")
    tr.add_argument("--checkpoint-backend", default="npz",
                    choices=["npz", "orbax"],
                    help="checkpoint format: this package writes its own .pt "
                         "files; orbax directories are not supported")
    tr.add_argument("--async-checkpoint", action="store_true",
                    help="no effect here (asynchronous saves are an orbax "
                         "feature of the JAX package)")
    tr.add_argument("--scan-steps", default="1",
                    help="train this many optimizer steps per chunk of "
                         "stacked input batches (cadence semantics "
                         "unchanged, 1 = per-batch). 'auto' derives K from "
                         "validation-interval and a device-memory budget for "
                         "the stacked input chunk (trainer.auto_scan_steps)")
    tr.add_argument("--num-iterations", type=int, default=10,
                    help="synthetic batches per epoch")

    ev = p.add_argument_group("Evaluate Models")
    ev.add_argument("--checkpoint-list", nargs="*", default=None)
    ev.add_argument("--eval-sfno", action="store_true",
                    help="include the scale=0 pure-SFNO baseline")

    lg = p.add_argument_group("Logging")
    lg.add_argument("--log-file", default=None)
    lg.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace of the action into "
                         "this directory (TensorBoard / Perfetto-loadable; "
                         "the reference has no profiler integration)")
    lg.add_argument("--advanced-logging", action="store_true")
    lg.add_argument("--wandb", action="store_true")
    lg.add_argument("--wandb-resume", default=None, metavar="RUN_ID",
                    help="resume an existing wandb run (resume='must', "
                    "reference train.py:106-114)")

    arch = p.add_argument_group("Architecture")
    arch.add_argument("--spectral-transform", default="sht", choices=["sht", "fft"])
    arch.add_argument("--filter-type", default="non-linear",
                      choices=["non-linear", "linear"])
    arch.add_argument("--img-size", type=int, nargs=2, default=[721, 1440])
    arch.add_argument("--scale-factor", type=int, default=6)
    arch.add_argument("--in-chans", type=int, default=73)
    arch.add_argument("--out-chans", type=int, default=73)
    arch.add_argument("--embed-dim", type=int, default=256)
    arch.add_argument("--num-layers", type=int, default=12)
    arch.add_argument("--spectral-layers", type=int, default=3)
    arch.add_argument("--mlp-ratio", type=float, default=2.0)
    arch.add_argument("--normalization-layer", default="instance_norm")
    arch.add_argument("--hard-thresholding-fraction", type=float, default=1.0)
    arch.add_argument("--compression", default=None, choices=[None, "tt"])
    arch.add_argument("--rank", type=int, default=128)
    arch.add_argument("--checkpointing-mlp", action="store_true")
    arch.add_argument("--checkpointing-block", action="store_true")
    arch.add_argument("--checkpointing-encoder", action="store_true")
    arch.add_argument("--checkpointing-decoder", action="store_true")
    arch.add_argument("--compute-dtype", default="float32",
                      choices=["float32", "bfloat16"])
    arch.add_argument("--output-dtype", default="float32",
                      choices=["float32", "bfloat16"],
                      help="model output field dtype; bfloat16 halves the "
                           "rollout carry copy + decoder write on the "
                           "serving tier (training keeps float32 targets)")
    arch.add_argument("--use-pallas", action="store_true")
    arch.add_argument("--spectral-mxu-dtype", default="float32",
                      choices=["float32", "bfloat16"])
    arch.add_argument("--sht-mxu-dtype", default="float32",
                      choices=["float32", "bfloat16"],
                      help="MXU input dtype for the SHT's DFT/Legendre "
                           "matmuls (fp32 accumulate); bfloat16 is the "
                           "fast-tier setting")
    arch.add_argument("--pallas-grid-mlp", action="store_true",
                      help="fused kernel for the full-res encoder/decoder "
                      "MLPs (csrc/grid_mlp.cu)")
    arch.add_argument("--grid-mlp-mxu-dtype", default="bfloat16",
                      choices=["float32", "bfloat16"])
    arch.add_argument("--no-fuse-decoder-tail", action="store_true",
                      help="disable the fused spectral->output decoder tail "
                           "(csrc/spectral_decoder.cu; engages with "
                           "--pallas-grid-mlp on the standard SHT/instance-"
                           "norm/big-skip configuration)")
    arch.add_argument("--no-fuse-encoder-dft", action="store_true",
                      help="disable the fused encoder->spectral head "
                           "(csrc/grid_encoder_spectral.cu)")
    arch.add_argument("--fuse-inner-mlp", action="store_true",
                      help="fold inner-block norm1+FiLM and the outer "
                           "identity skip into the channel-MLP kernel "
                           "(blocks.py fuse_mlp_affine)")
    arch.add_argument("--no-pallas-gcn", action="store_true",
                      help="disable the fused GCN-layer kernel in the "
                           "gcn/gcn_custom film generators "
                           "(csrc/gcn_layer.cu)")

    dist = p.add_argument_group("Distributed")
    dist.add_argument("--mesh", default="auto",
                      help="device mesh (replaces the reference's --ddp "
                           "launcher, main.py:39-49,1149-1156): 'auto' trains "
                           "data-parallel over the processes torchrun "
                           "started when there is more than one; 'none' "
                           "forces a single process; or explicit sizes "
                           "'DATA,LAT,CHANNEL' with DATA the world size and "
                           "LAT = CHANNEL = 1, e.g. --mesh 2,1,1")
    dist.add_argument("--coordinator-address", default=None,
                      help="host:port of rank 0 for torch.distributed (the "
                           "reference's MASTER_ADDR/PORT, main.py:45-46); "
                           "torchrun's environment is used when omitted")
    dist.add_argument("--num-processes", type=int, default=None)
    dist.add_argument("--process-id", type=int, default=None)

    film = p.add_argument_group("Architecture Film Gen")
    film.add_argument("--film-gen", dest="film_gen_type", default="gcn_custom",
                      choices=["gcn", "gcn_custom", "transformer", "mae", "none"])
    film.add_argument("--film-layers", type=int, default=1)
    film.add_argument("--film-compute-dtype", default="float32",
                      choices=["float32", "bfloat16"],
                      help="film-generator activation dtype; its bf16 drift "
                      "dominates the fast tier's error")
    film.add_argument("--repeat-film", action="store_true")
    film.add_argument("--model-depth", type=int, default=6)
    film.add_argument("--film-embed-dim", type=int, default=512)
    film.add_argument("--mlp-dim", type=int, default=512)
    film.add_argument("--temporal-step", type=int, default=28)
    film.add_argument("--patch-size", type=int, nargs=3, default=[28, 9, 9],
                      help="(t, h, w) patch for vit/mae film generators")
    film.add_argument("--coarse-level", type=int, default=4)
    film.add_argument("--nan-mask-threshold", type=float, default=0.5)
    film.add_argument("--scale-weight", type=float, default=1.0,
                      help="mae film-head init divisor (main.py:962)")
    return p


def postprocess_args(args, world_size: int = 1):
    """Derived-config munging replicated from the reference (main.py:115-136):
    step-skip expansion (the rollout covers (k+1)x the supervised steps) and
    the scheduler-horizon rescale by batch x (acc + 1) x world size; the
    schedule advances once per optimizer update."""
    if args.training_step_skip > 0:
        if args.multi_step_training > 0:
            args.multi_step_training += args.training_step_skip * args.multi_step_training
        else:
            log.warning("--training-step-skip given but --multi-step-training is 0")
    if args.validation_step_skip > 0:
        if args.multi_step_validation > 0:
            args.multi_step_validation += args.validation_step_skip * args.multi_step_validation
        else:
            log.warning("--validation-step-skip given but --multi-step-validation is 0")
    if args.scheduler != "none":
        args.scheduler_horizon = max(
            args.scheduler_horizon // (args.batch_size * (args.accumulation_steps + 1) * world_size),
            1,
        )
    return args


def parse_time_limit(value: str | None) -> float | None:
    """"HH:MM:SS" | "MM:SS" | seconds -> seconds (main.py:149-156)."""
    if value is None:
        return None
    secs = 0.0
    for part in (float(x) for x in str(value).split(":")):
        secs = secs * 60 + part
    return secs


# --scan-steps auto's budget without a card: the JAX package's default when
# the device reports no memory limit (16 GiB) over four
CPU_SCAN_BUDGET_BYTES = 16 * 2**30 // 4


def configs_from_args(args):
    from msfno_torch.config import FilmConfig, SFNOConfig, TrainConfig

    film = None
    if args.model_version == "film" or args.model == "mae":
        film = FilmConfig(
            film_gen_type=args.film_gen_type,
            film_layers=args.film_layers,
            repeat_film=args.repeat_film,
            model_depth=args.model_depth,
            embed_dim=args.film_embed_dim,
            mlp_dim=args.mlp_dim,
            temporal_step=args.temporal_step,
            patch_size=tuple(args.patch_size),
            coarse_level=args.coarse_level,
            sst_shape=((args.img_size[0] - 1) // args.coarse_level,
                       args.img_size[1] // args.coarse_level),
            nan_mask_threshold=args.nan_mask_threshold,
            num_film_features=args.embed_dim,
            scale_weight=args.scale_weight,
            dropout=args.dropout,
            cls_input=bool(args.cls),
            compute_dtype=args.film_compute_dtype,
            pallas_gcn=not args.no_pallas_gcn,
        )
    model_cfg = SFNOConfig(
        img_size=tuple(args.img_size),
        scale_factor=args.scale_factor,
        in_chans=args.in_chans,
        out_chans=args.out_chans,
        embed_dim=args.embed_dim,
        num_layers=args.num_layers,
        spectral_transform=args.spectral_transform,
        filter_type=args.filter_type,
        mlp_ratio=args.mlp_ratio,
        normalization_layer=args.normalization_layer,
        hard_thresholding_fraction=args.hard_thresholding_fraction,
        compression=args.compression,
        rank=args.rank,
        spectral_layers=args.spectral_layers,
        checkpointing_mlp=args.checkpointing_mlp,
        checkpointing_block=args.checkpointing_block,
        checkpointing_encoder=args.checkpointing_encoder,
        checkpointing_decoder=args.checkpointing_decoder,
        compute_dtype=args.compute_dtype,
        use_pallas=args.use_pallas,
        spectral_mxu_dtype=args.spectral_mxu_dtype,
        sht_mxu_dtype=args.sht_mxu_dtype,
        pallas_grid_mlp=args.pallas_grid_mlp,
        grid_mlp_mxu_dtype=args.grid_mlp_mxu_dtype,
        fuse_decoder_tail=not args.no_fuse_decoder_tail,
        fuse_encoder_dft=not args.no_fuse_encoder_dft,
        fuse_inner_mlp=args.fuse_inner_mlp,
        output_dtype=args.output_dtype,
        film=film,
    )
    auto = str(args.scan_steps).lower() == "auto"
    train_cfg = TrainConfig(
        batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        optimizer=args.optimizer,
        weight_decay=args.weight_decay,
        scheduler=args.scheduler,
        scheduler_horizon=args.scheduler_horizon,
        loss_fn=args.loss_fn,
        multi_step_training=args.multi_step_training,
        training_step_skip=args.training_step_skip,
        discount_factor=args.discount_factor,
        accumulation_steps=args.accumulation_steps,
        validation_interval=args.validation_interval,
        validation_step_skip=args.validation_step_skip,
        multi_step_validation=args.multi_step_validation,
        save_checkpoint_interval=args.save_checkpoint_interval,
        training_epochs=args.training_epochs,
        film_scale_start=args.film_scale_start,
        retrain_film=args.retrain_film,
        seed=args.seed,
        time_limit_s=parse_time_limit(args.time_limit),
        scan_steps=1 if auto else int(args.scan_steps),
        checkpoint_backend=args.checkpoint_backend,
        async_checkpoint=args.async_checkpoint,
        bf16_frozen_params=args.bf16_frozen_params,
        advanced_logging=args.advanced_logging,
    )
    if auto:
        from msfno_torch.training.trainer import auto_scan_steps

        budget = CPU_SCAN_BUDGET_BYTES if args.cpu else None
        train_cfg = dataclasses.replace(
            train_cfg, scan_steps=auto_scan_steps(model_cfg, train_cfg, hbm_budget_bytes=budget))
    return model_cfg, train_cfg


def explicit_flags(argv=None) -> set[str]:
    """Dest names of the flags explicitly present on the command line:
    argv re-parsed with every default replaced by a sentinel, so
    `--flag=value` spellings, prefix abbreviations and main(argv=[...])
    calls are all detected."""
    p = build_parser()
    sentinel = object()
    for a in p._actions:
        a.default = sentinel
    ns, _ = p.parse_known_args(sys.argv[1:] if argv is None else argv)
    return {k for k, v in vars(ns).items() if v is not sentinel}


PROTECTED = {"img_size", "scale_factor", "in_chans", "out_chans", "embed_dim", "num_layers",
             "spectral_layers", "spectral_transform", "filter_type", "normalization_layer"}


def merge_resume_config(model_cfg, args, argv=None):
    """Checkpoint-hyperparameter merge on resume: the stored config wins
    unless the flag was passed explicitly; the architecture always comes
    from the checkpoint (reference main.py:179-246).  Reads a `.pt` or a
    JAX `.npz` through `checkpoint.peek`."""
    from msfno_torch.config import from_json
    from msfno_torch.training.checkpoint import peek

    meta = peek(args.resume_checkpoint)
    stored = from_json(meta["config"])
    passed = explicit_flags(argv)
    overrides = {f.name: getattr(model_cfg, f.name) for f in dataclasses.fields(type(stored))
                 if f.name not in PROTECTED and f.name in passed}
    return dataclasses.replace(stored, **overrides), meta


def build_backend(args):
    """--era5-path -> NpyBackend (directory of era5_*.npy) or ZarrBackend."""
    from msfno_torch.data.era5 import NpyBackend, ZarrBackend

    path = args.era5_path
    if os.path.isdir(path) and any(f.startswith("era5_") for f in os.listdir(path)):
        return NpyBackend(path)
    return ZarrBackend(path, sst_path=args.sst_path)


def build_loaders(args, model_cfg, train_cfg, argv=None):
    """--era5-path -> backend -> ERA5Dataset -> PrefetchLoader (reference
    set_dataloader, train.py:448-521).  Returns (train_loader | None,
    val_loader_factory | None).  Under a torch.distributed group each
    loader reads its rank's share (`PrefetchLoader`'s default shard)."""
    if not args.era5_path or args.synthetic_data:
        return None, None
    from msfno_torch.data.era5 import ERA5Dataset, PrefetchLoader, year_range_indices

    backend = build_backend(args)
    n = len(backend)
    explicit = explicit_flags(argv)

    def year_window(y0, y1, flag_names):
        s, e = year_range_indices(args.dataset_start_year, y0, y1)
        # an explicit year range that does not fit the store must not clamp
        # or fall back to the whole store
        if explicit & flag_names and (s >= n or s < 0 or e <= s or e > n):
            raise SystemExit(
                f"--{sorted(explicit & flag_names)[0].replace('_', '-')}: "
                f"year range {y0}-{y1} maps to steps [{s}, {e}] but the "
                f"store has {n}; fix the year flags or --dataset-start-year")
        if s >= n:
            log.warning("year range %d-%d starts past the store (%d of %d steps); "
                        "using the full store", y0, y1, s, n)
            return 0, None
        return s, min(e, n)

    film = model_cfg.film
    common = dict(backend=backend, temporal_step=film.temporal_step if film else 28,
                  with_sst=film is not None and not film.cls_input, past_sst=args.past_sst,
                  dataset_start_year=args.dataset_start_year)
    tr_s, tr_e = year_window(args.trainingset_start_year, args.trainingset_end_year,
                             {"trainingset_start_year", "trainingset_end_year"})
    va_s, va_e = year_window(args.validationset_start_year, args.validationset_end_year,
                             {"validationset_start_year", "validationset_end_year"})
    train_ds = ERA5Dataset(multi_step=train_cfg.multi_step_training, start_idx=tr_s,
                           end_idx=tr_e, **common)
    val_ds = ERA5Dataset(multi_step=train_cfg.multi_step_validation, start_idx=va_s,
                         end_idx=va_e, **common)
    transfer_dtype = torch.bfloat16 if args.input_transfer_dtype == "bfloat16" else None
    train_loader = PrefetchLoader(train_ds, batch_size=train_cfg.batch_size,
                                  shuffle=not args.no_shuffle, seed=args.seed,
                                  num_workers=args.training_workers,
                                  transfer_dtype=transfer_dtype)
    val_prefetch = PrefetchLoader(val_ds, batch_size=args.batch_size_validation
                                  or train_cfg.batch_size, shuffle=False,
                                  num_workers=args.training_workers,
                                  transfer_dtype=transfer_dtype)

    def val_factory():
        import itertools

        return itertools.islice(val_prefetch.epoch(0), args.validation_batches)

    return train_loader, val_factory


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def resolve_mesh(args, device=None):
    """The CLI's mesh (the wiring the reference does with mp.spawn +
    ddp_setup behind --ddp, main.py:39-49,1149-1156), after joining the
    torch.distributed group (`initialize_distributed`: torchrun's
    environment or --coordinator-address):
      --mesh none   -> None (one process);
      --mesh auto   -> the data-only mesh of the world size when torchrun
                       (or the flags) started more than one process, else
                       None;
      --mesh D,L,C  -> make_mesh; D must be the world size and L = C = 1.
                       1,1,1 in a lone process joins a group of one.
    The mesh flows into the Trainer; --run, --save-forecast and
    --eval-model compute on every rank and write from rank 0."""
    from msfno_torch.parallel.distributed import initialize_distributed
    from msfno_torch.parallel.mesh import LATER, make_mesh

    mesh_arg = (args.mesh or "auto").strip().lower()
    if mesh_arg == "none":
        return None
    shape = None
    if mesh_arg != "auto":
        try:
            shape = tuple(int(x) for x in mesh_arg.split(","))
        except ValueError:
            shape = ()
        if len(shape) != 3 or any(s < 1 for s in shape):
            raise SystemExit(f"--mesh must be 'auto', 'none', or three comma-separated "
                             f"sizes data,lat,channel (got {args.mesh!r})")
        if shape[1] * shape[2] > 1:
            raise SystemExit(f"--mesh {args.mesh}: {LATER}")
    initialize_distributed(coordinator_address=args.coordinator_address,
                           num_processes=args.num_processes, process_id=args.process_id,
                           device=device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if shape is not None:
        if shape[0] == 1 and not dist.is_initialized():
            initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0, device)
            world = 1
        if shape[0] != world:
            raise SystemExit(f"--mesh {args.mesh} needs {math.prod(shape)} processes, one per "
                             f"device, but the world size is {world}; launch it with "
                             f"torchrun --nproc_per_node {shape[0]}")
        return make_mesh(shape=shape)
    if world > 1:
        mesh = make_mesh(shape=(world, 1, 1))
        log.info("data-parallel mesh over %d processes", world)
        return mesh
    n = torch.cuda.device_count() if torch.cuda.is_available() and not args.cpu else 1
    if n > 1:
        log.info("%d cards are visible; this process runs on one. "
                 "torchrun --nproc_per_node %d -m msfno_torch.cli ... spreads the work "
                 "over all of them", n, n)
    return None


def _overlay(module, params: dict, reference: bool, what: str) -> None:
    """Copy the checkpoint's tensors into the module's parameters of the same
    names (strict=False, reference model.py:216-256: a backbone-only file
    keeps a filmed net's generator as initialised)."""
    own = dict(module.named_parameters())
    unknown = [k for k in params if k not in own]
    if unknown:
        (log.warning if reference else log.info)("%s keys not in the net (ignored): %s",
                                                  what, unknown[:10])
    with torch.no_grad():
        for k, v in params.items():
            if k in own:
                own[k].copy_(v.to(own[k].dtype))


def restore_train_state(state, trainer, args, model_cfg, train_cfg):
    """Resume semantics (reference main.py:179-246 + train.py:398-431):
    the parameters always come from the checkpoint, the optimizer state only
    under --resume-optimizer and the schedule position only under
    --resume-scheduler (`Trainer.restore`).  A reference checkpoint carries
    parameters only: they are overlaid onto the initialised net."""
    from msfno_torch.models.registry import is_reference_checkpoint, read_checkpoint

    path = args.resume_checkpoint
    if is_reference_checkpoint(path):
        params, _, _ = read_checkpoint(path)
        _overlay(trainer.model, params, True, "resume")
        if args.resume_optimizer:
            log.warning("--resume-optimizer has no effect on a reference checkpoint; "
                        "optimizer state starts fresh")
        state.step, state.film_scale = 0, float(train_cfg.film_scale_start)
        trainer.iter = trainer.epoch = trainer.start_epoch = 0
        return state
    return trainer.restore(state, path, resume_optimizer=args.resume_optimizer,
                           resume_scheduler=args.resume_scheduler)


def _rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _print(obj) -> None:
    if _rank0():
        print(json.dumps(obj))


def _uses_mesh(args) -> bool:
    return ((args.train and args.model != "mae") or args.test_performance
            or args.test_batch_size or args.save_forecast or args.eval_model or args.run)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    joined_before = dist.is_initialized()
    try:
        rc = _profiled(args, argv) if args.profile_dir else _main(args, argv)
    except BaseException:
        if dist.is_initialized() and not joined_before:
            dist.destroy_process_group()  # no barrier: another rank may never reach it
        raise
    if dist.is_initialized() and not joined_before:  # leave the group this run joined
        dist.barrier()
        dist.destroy_process_group()
    return rc


def _profiled(args, argv) -> int:
    """--profile-dir: the whole action under torch.profiler, its trace
    written to that directory (TensorBoard / Perfetto)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    acts = [ProfilerActivity.CPU] + ([] if args.cpu else [ProfilerActivity.CUDA])
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(args.profile_dir)):
        rc = _main(args, argv)
        if not args.cpu:
            torch.cuda.synchronize()
    log.info("profiler trace written to %s", args.profile_dir)
    return rc


def _main(args, argv=None) -> int:
    from msfno_torch.parallel.distributed import torchrun_env, world_size_hint
    from msfno_torch.runtime import resolve_device

    logging.basicConfig(level=logging.DEBUG if args.debug else logging.INFO,
                        filename=args.log_file,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    t0 = time.time()
    device = "cpu" if args.cpu else None
    try:
        resolve_device(device)
    except RuntimeError as e:  # no card and no --cpu: stop here
        raise SystemExit(f"msfno_torch.cli: {e}; on the command line: --cpu") from e
    if args.checkpoint_backend == "orbax":
        raise SystemExit("--checkpoint-backend orbax: orbax.checkpoint imports jax, which "
                         "this package never imports (ROADMAP Queue 1 item 2); its "
                         "checkpoints are .pt files, and it reads JAX .npz files")

    world = world_size_hint()
    if (world > 1 and not dist.is_initialized() and not torchrun_env()
            and args.coordinator_address is None):
        # a scheduler started several processes that cannot form a group:
        # each would train alone on 1/world of the horizon into one output
        raise SystemExit(f"msfno_torch.cli: {world} processes were launched (SLURM_NTASKS / "
                         f"OMPI_COMM_WORLD_SIZE) but none can join a torch.distributed "
                         f"group; launch with torchrun --nproc_per_node N, or pass "
                         f"--coordinator-address, --num-processes and --process-id")
    args = postprocess_args(args, world_size=world)
    model_cfg, train_cfg = configs_from_args(args)
    from msfno_torch.models.registry import (
        get_model,
        is_reference_checkpoint,
        load_statistics,
        read_checkpoint,
    )

    if args.resume_checkpoint and not is_reference_checkpoint(args.resume_checkpoint):
        # a reference checkpoint carries no config: its architecture comes
        # from the flags (loading still fails on a shape mismatch)
        model_cfg, _ = merge_resume_config(model_cfg, args, argv=argv)
    # join the group before anything touches a card: "cuda" is this rank's
    mesh = resolve_mesh(args, device) if _uses_mesh(args) else None
    os.makedirs(args.output_path, exist_ok=True)
    rank0 = _rank0()

    if args.dump_provenance and rank0:
        from msfno_torch.utils.observability import dump_provenance

        path = dump_provenance(os.path.join(args.output_path, "provenance.json"), device)
        log.info("provenance written to %s", path)

    wrapper = None

    def get_wrapper():
        nonlocal wrapper
        if wrapper is None:
            wrapper = get_model(args.model, args.model_version, cfg=model_cfg,
                                assets=args.assets, device=device)
        return wrapper

    def trainer_of(**kw):
        from msfno_torch.data.normalization import SSTNormalizer
        from msfno_torch.training.trainer import Trainer

        return Trainer(model_cfg, train_cfg, normalizer=load_statistics(args.assets,
                                                                        model_cfg.in_chans),
                       sst_normalizer=SSTNormalizer.identity(), device=device, **kw)

    def writer_of():
        from msfno_torch.utils.observability import create_writer

        return create_writer(save_dir=args.output_path, use_wandb=args.wandb,
                             project=f"{args.model}-{args.model_version}",
                             resume_id=args.wandb_resume)

    if args.film_weights:
        # merge film-generator weights onto the backbone (reference
        # film-checkpoint merge, sfno/model.py:909-912, 983-1005)
        params, _, reference = read_checkpoint(args.film_weights)
        film_only = {k: v for k, v in params.items()
                     if k.split(".")[0] in ("film_gen", "film_head")}
        _overlay(get_wrapper().module, film_only, reference, "film-weights")

    if args.train and args.model == "mae" and args.model_version == "lin-probe":
        # linear probe: ridge-fit precomputed MAE cls tokens -> ONI index
        # (reference Linear_probing, mae/model.py:177-276; main.py:554-562)
        if not (args.cls and args.oni_path):
            log.error("lin-probe needs --cls and --oni-path .npy files")
            return 1
        cls_tokens = np.load(args.cls)
        oni = np.load(args.oni_path).reshape(-1)
        n = min(len(cls_tokens), len(oni))
        cls_tokens, oni = cls_tokens[:n], oni[:n]
        if n < 2:
            log.error("lin-probe needs >= 2 samples (got %d) for a train/test split", n)
            return 1
        split = min(max(int(n * 0.8), 1), n - 1)
        probe = get_wrapper()
        probe.fit(cls_tokens[:split], oni[:split])
        mae = probe.mae_metric(cls_tokens[split:], oni[split:])
        clim = float(np.mean(np.abs(oni[split:] - np.mean(oni[:split]))))
        probe.save_checkpoint(os.path.join(args.output_path, "checkpoint_linprobe.pt"))
        _print({"lin_probe_mae": mae, "climatology_mae": clim})
        return 0

    if args.train and args.model == "mae":
        # MAE SST pretraining (reference mae --train, train.py:318-339):
        # stochastic-mask CRPS reconstruction over SST history windows
        f = model_cfg.film

        def sst_batches():
            if args.sst_path or args.era5_path:
                # SST-only reads: a pure-SST store works (no era5_*.npy)
                from msfno_torch.data.sst import SSTNpyStore

                store = SSTNpyStore(args.sst_path or args.era5_path, temporal_step=f.temporal_step)
                yield from store.batches(train_cfg.batch_size, epochs=train_cfg.training_epochs,
                                         seed=args.seed)
            else:
                from msfno_torch.data.synthetic import synthetic_sst

                rng = np.random.default_rng(args.seed)
                for _ in range(args.num_iterations):
                    yield synthetic_sst(rng, train_cfg.batch_size, f.temporal_step, *f.sst_shape)

        writer = writer_of()
        mae_wrapper = get_wrapper()
        _, losses = mae_wrapper.pretrain(sst_batches(), learning_rate=train_cfg.learning_rate,
                                         seed=args.seed, writer=writer)
        mae_wrapper.save_checkpoint(os.path.join(args.output_path, "checkpoint_mae_final.pt"))
        writer.save("_mae")
        log.info("mae pretraining done: final crps %.5f", losses[-1])
        return 0

    if args.train or args.test_performance or args.test_batch_size:
        trainer = trainer_of(checkpoint_dir=args.output_path, mesh=mesh, writer=writer_of())
        if args.test_batch_size:
            if args.batch_size_step > 0:
                # the reference grows linearly by batch_size_step until OOM
                # (train.py:1296-1337)
                best = trainer.test_batch_size(tuple(args.batch_size_step * k
                                                     for k in range(1, 17)))
            else:
                best = trainer.test_batch_size()
            _print({"max_batch_size": best})
            return 0
        state = trainer.init_state()
        if args.sfno_weights:
            # pretrained backbone for film fine-tuning (reference
            # sfno-weights, main.py:410 + sfno/model.py:207-271): the file's
            # weights overlay the net, the film generator keeps its init and
            # the trainable / frozen split stays
            params, _, reference = read_checkpoint(args.sfno_weights)
            _overlay(trainer.model, params, reference, "sfno-weights")
        if args.resume_checkpoint:
            state = restore_train_state(state, trainer, args, model_cfg, train_cfg)
        if mesh is not None and (args.sfno_weights or args.resume_checkpoint):
            from msfno_torch.parallel.sharded_train import shard_state

            state = shard_state(state, mesh)
        if args.set_epoch is not None:
            trainer.start_epoch = args.set_epoch
        if args.test_performance:
            _print({"model_fwd_s": trainer.test_model_speed(state)})
            return 0
        train_loader, val_factory = build_loaders(args, model_cfg, train_cfg, argv)
        trainer.train(state, loader=train_loader, val_loader=val_factory,
                      num_batches=args.num_iterations)
        log.info("training done in %.1fs", time.time() - t0)
        return 0

    if args.save_forecast:
        # weatherbench2-format forecast dump (reference main.py:298 ->
        # Trainer.save_forecast, train.py:942-1110)
        from msfno_torch.training.trainer import save_forecast as save_forecast_fn

        trainer = trainer_of(mesh=mesh)
        state = trainer.init_state()
        if args.resume_checkpoint:
            state = restore_train_state(state, trainer, args, model_cfg, train_cfg)
        _, val_factory = build_loaders(args, model_cfg, train_cfg, argv)
        steps = max(train_cfg.multi_step_validation, 1)
        if val_factory is not None:
            batches = list(val_factory())
        else:
            from msfno_torch.data.synthetic import gen_batch

            batches = [gen_batch(model_cfg, train_cfg.batch_size, steps, seed=i)
                       for i in range(args.num_iterations)]
        out = save_forecast_fn(
            trainer, state, batches, steps=steps,
            out_path=os.path.join(args.output_path, "forecast_store") if rank0 else None,
            channels=list(getattr(get_wrapper(), "ordering", [])) or None)
        log.info("forecast archive written to %s", out)
        return 0

    if args.eval_model:
        # checkpoint skill evaluation (reference main.py:303-337 ->
        # evaluate_model, sfno/model.py:1292-1486)
        from msfno_torch.inference.eval_checkpoints import (
            evaluate_checkpoints,
            select_checkpoints,
        )

        cps = args.checkpoint_list or select_checkpoints(
            os.path.join(args.output_path, "checkpoint_*"))
        if not cps:
            log.error("no checkpoints to evaluate (--checkpoint-list or checkpoint_* "
                      ".pt/.npz under --output-path)")
            return 1
        _, val_factory = build_loaders(args, model_cfg, train_cfg, argv)
        steps = max(train_cfg.multi_step_validation, 1)
        if val_factory is not None:
            batches = list(val_factory())
        else:
            from msfno_torch.data.synthetic import gen_batch

            batches = [gen_batch(model_cfg, train_cfg.batch_size, steps, seed=100 + i)
                       for i in range(2)]
        if args.climatology_path:
            clim = np.load(args.climatology_path)
        else:
            log.warning("no --climatology-path; using the batch time-mean as the skill "
                        "reference")
            clim = np.mean(np.stack([np.asarray(b.era5) for b in batches]), axis=(0, 1, 2))
        w = get_wrapper()
        reports = evaluate_checkpoints(
            w.module, cps, batches, climatology=clim, steps=steps, normalizer=w.normalizer,
            sst_normalizer=w.sst_normalizer,
            save_path=os.path.join(args.output_path, "eval") if rank0 else None,
            include_sfno_baseline=args.eval_sfno, device=device)
        for name, rep in reports.items():
            log.info("%s: mean skill %.4f", name, float(np.mean(rep.skill)))
        return 0

    if args.run:
        return _run(args, model_cfg, get_wrapper(), rank0)

    if args.test_dataloader_speed:
        trainer = trainer_of()
        train_loader, _ = build_loaders(args, model_cfg, train_cfg, argv)
        if train_loader is not None:
            it = train_loader.epoch(0)
        else:
            from msfno_torch.data.synthetic import synthetic_loader

            it = synthetic_loader(model_cfg, train_cfg.batch_size, 0, 10)
        _print({"dataloader_s_per_batch": trainer.test_dataloader_speed(it)})
        return 0

    if args.save_data:
        trainer = trainer_of()
        train_loader, _ = build_loaders(args, model_cfg, train_cfg, argv)
        if train_loader is not None:
            it = train_loader.epoch(0)
        else:
            from msfno_torch.data.synthetic import synthetic_loader

            it = synthetic_loader(model_cfg, train_cfg.batch_size,
                                  train_cfg.multi_step_training, args.num_iterations)
        out = trainer.save_data(it, os.path.join(args.output_path, "data"),
                                num_batches=args.num_iterations)
        log.info("batches written to %s", out)
        return 0

    build_parser().print_help()
    return 0


def _run(args, model_cfg, wrapper, rank0: bool) -> int:
    """--run: an autoregressive forecast from a store, an .npy initial
    state or a seeded random one, with the SST windows of a filmed model,
    written as forecast.npz or per-step files (reference main.py:339)."""
    if not 0 <= args.time < 24:
        # the reference's --time is HHMM (1200 = noon); here it is the hour
        raise SystemExit(
            f"--time takes an hour 0-23 (got {args.time}); the reference's HHMM format is "
            f"not accepted — e.g. pass --time 12 for the reference's --time 1200")
    if not args.film_weights:
        wrapper.load_model(args.resume_checkpoint)
    rng = np.random.default_rng(args.seed)
    h, w = model_cfg.img_size
    store_backend, store_idx = None, 0
    if args.era5_path and (os.path.isdir(args.era5_path)
                           or args.era5_path.rstrip("/").endswith(".zarr")):
        # a store directory (the form --train takes): the initial condition
        # is selected by --date / --time, by default the first step
        from msfno_torch.data.era5 import yyyymmddhh_to_index

        store_backend = build_backend(args)
        if args.date:
            store_idx = yyyymmddhh_to_index(args.dataset_start_year,
                                            int(args.date) * 100 + args.time)
            if not 0 <= store_idx < len(store_backend):
                log.error("--date %s --time %02d is outside the store (index %d of %d)",
                          args.date, args.time, store_idx, len(store_backend))
                return 1
        x0 = store_backend.era5(store_idx)[None]
    elif args.era5_path:
        x0 = np.load(args.era5_path)
    else:
        log.warning("no --era5-path; running from a random initial condition")
        x0 = rng.standard_normal((1, h, w, model_cfg.in_chans)).astype(np.float32)
    sst_seq = None
    if model_cfg.film is not None:
        steps = args.lead_time // 6
        f = model_cfg.film
        if args.sst_path and not os.path.isdir(args.sst_path):
            sst_seq = np.load(args.sst_path)
        elif store_backend is not None and store_backend.sst(store_idx) is not None:
            # per-step SST windows from the store with the training-time
            # convention (window index step + 1); windows outside the store
            # are an error
            from msfno_torch.data.era5 import rollout_sst_window_start

            T = f.temporal_step
            starts = [rollout_sst_window_start(store_idx, s, T, args.past_sst)
                      for s in range(steps)]
            lo, hi = starts[0], starts[-1] + T - 1
            if lo < 0 or hi >= len(store_backend):
                raise SystemExit(
                    f"--lead-time {args.lead_time} from store index {store_idx} needs SST "
                    f"frames [{lo}, {hi}] but the store has [0, {len(store_backend) - 1}]; "
                    f"shorten --lead-time, pick another --date, toggle --past-sst, or supply "
                    f"--sst-path")
            sst_seq = np.stack([np.stack([store_backend.sst(w0 + k) for k in range(T)])
                                for w0 in starts])[:, None]  # (steps, B=1, T, Hs, Ws)
        else:
            log.warning("filmed model without --sst-path; synthetic SST")
            from msfno_torch.data.synthetic import synthetic_land_mask

            sst_seq = rng.standard_normal((steps, 1, f.temporal_step, *f.sst_shape)
                                          ).astype(np.float32)
            sst_seq[..., synthetic_land_mask(*f.sst_shape)] = np.nan
    writer = None
    if (args.hindcast or args.hindcast_reference_year is not None) and \
            args.output not in ("file", "netcdf"):
        log.warning("--hindcast relabeling applies to step-writing outputs only; pass "
                    "--output file or --output netcdf (got %r)", args.output)
    if args.output in ("file", "netcdf") and rank0:
        from msfno_torch.inference.io import HindcastReLabel, get_output

        variables = None
        if args.output_variables:
            with open(args.output_variables) as fh:
                variables = json.loads(fh.read())
        writer = get_output(args.output, path=os.path.join(args.output_path, "forecast"),
                            ordering=list(getattr(wrapper, "ordering", [])) or None,
                            variables=variables)
        if args.hindcast or args.hindcast_reference_year is not None:
            ref_year = args.hindcast_reference_year or (int(args.date[:4]) if args.date
                                                        else 2020)
            start = int(args.date) if args.date else ref_year * 10000 + 101
            writer = HindcastReLabel(None, writer, reference_date=ref_year * 10000 + start % 10000,
                                     hdate=start)
    outs = list(wrapper.running(x0, lead_time_h=args.lead_time, sst_seq=sst_seq, output=writer))
    if args.output == "npz" and rank0:
        out_file = os.path.join(args.output_path, "forecast.npz")
        np.savez(out_file, forecast=np.stack(outs))
        log.info("forecast written to %s", out_file)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
