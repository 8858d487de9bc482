"""Training CLI with the reference launchers' flags (train.sh / finetune.sh).

    python -m ap_adapter_torch.train.cli \\
        --train-manifest $DATA_DIR/manifest.json \\
        --random-weights \\
        --output-dir $OUTPUT_DIR \\
        --train-batch-size 8 --gradient-accumulation-steps 4 \\
        --learning-rate 1e-4 --max-train-steps 35000

``--checkpoint-dir`` names a directory of HF/diffusers state dicts, one
``<submodel>.npz`` per submodel (clap, t5, gpt2, projection, audiomae, unet,
vae, vocoder), which ``python -m ap_adapter_torch.convert.cli`` writes from
the public AudioLDM2 directory and AudioMAE's ``pretrained.pth``; ``--random-weights`` draws random weights from ``--seed``
instead. Resume from a flat adapter checkpoint with
``--resume-from-checkpoint``; without it the adapter starts as each site's
copy of its frozen to_k/to_v. ``--remat`` recomputes each resnet and
attention group in the backward pass; ``--use-8bit-adam`` keeps AdamW's
first moment in bf16; every ``--validation-steps`` optimizer steps
``--num-validation-audio-files`` clips are generated under
``<output-dir>/validation/`` (``--no-validation`` turns that off);
``--report-to tensorboard`` (``<output-dir>/tb``) or ``wandb`` adds a
metrics backend beside ``metrics.jsonl``, skipped where its package does not
import. Runs on the card (``--device``, default ``cuda``).

Data-parallel on N cards: start one process per rank, e.g. ``torchrun
--nproc-per-node N -m ap_adapter_torch.train.cli ...`` (or the JAX
package's ``APX_*`` variables). ``--train-batch-size`` is each rank's
batch; each optimizer step then averages the gradients of N x that batch,
and rank 0 alone writes under ``--output-dir``.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="AP-adapter finetuning (PyTorch)")
    p.add_argument("--train-manifest", required=True, help="AudioSet-style JSON manifest")
    p.add_argument("--data-root", default="")
    p.add_argument("--checkpoint-dir", default="", help="directory of <submodel>.npz state dicts, as python -m "
                   "ap_adapter_torch.convert.cli writes it")
    p.add_argument("--output-dir", default="ap_adapter_output")
    p.add_argument("--train-batch-size", type=int, default=8)
    p.add_argument("--dataloader-prefetch", type=int, default=2,
                   help="background-thread prefetch depth (0 disables)")
    p.add_argument("--gradient-accumulation-steps", type=int, default=4)
    p.add_argument("--learning-rate", type=float, default=1e-4)
    p.add_argument("--lr-scheduler", default="constant",
                   choices=["constant", "constant_with_warmup", "linear", "cosine"])
    p.add_argument("--lr-warmup-steps", type=int, default=500)
    p.add_argument("--scale-lr", action="store_true")
    p.add_argument("--adam-beta1", type=float, default=0.9)
    p.add_argument("--adam-beta2", type=float, default=0.999)
    p.add_argument("--adam-weight-decay", type=float, default=1e-2)
    p.add_argument("--adam-epsilon", type=float, default=1e-8)
    p.add_argument("--use-8bit-adam", action="store_true", help="AdamW with a bf16 first moment")
    p.add_argument("--max-grad-norm", type=float, default=1.0)
    p.add_argument("--max-train-steps", type=int, default=35_000)
    p.add_argument("--checkpointing-steps", type=int, default=3000)
    p.add_argument("--validation-steps", type=int, default=3000)
    p.add_argument("--duration", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--snr-gamma", type=float, default=None)
    p.add_argument("--resume-from-checkpoint", default=None, help="flat adapter dict (.npz)")
    p.add_argument("--random-weights", action="store_true", help="random base weights from --seed")
    p.add_argument("--remat", action="store_true",
                   help="recompute each resnet and attention group in the backward pass")
    p.add_argument("--num-validation-audio-files", type=int, default=3,
                   help="validation wavs generated per round (one batched generate)")
    p.add_argument("--report-to", default="jsonl", choices=["jsonl", "tensorboard", "wandb"],
                   help="extra metrics backend (JSONL is always written)")
    p.add_argument("--no-validation", action="store_true", help="disable validation sampling")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    """Run the CLI at the full width of ``PipelineConfig()``. Returns the
    final ``TrainState`` and the modules."""

    args = build_parser().parse_args(argv)

    from ap_adapter_torch.parallel.distributed import maybe_initialize, process_count, process_index

    distributed = maybe_initialize(args.device)     # join the ranks before anything is built

    import dataclasses

    from ap_adapter_torch.adapter.params import import_flat_adapter, init_adapter_from_text_kv
    from ap_adapter_torch.configs import PipelineConfig
    from ap_adapter_torch.parallel.mesh import create_mesh
    from ap_adapter_torch.pipeline.pipeline import PipelineModules, read_checkpoint_dir
    from ap_adapter_torch.train.data import AudioSetDataset, DeviceCollate, data_loader, prefetch
    from ap_adapter_torch.train.loop import train
    from ap_adapter_torch.train.trainer import TrainConfig
    from ap_adapter_torch.utils.checkpoint import load_flat_adapter

    mesh = create_mesh(device=args.device) if distributed else None
    device = mesh.device if mesh is not None else args.device
    config = PipelineConfig()
    config = config.replace(unet=dataclasses.replace(config.unet, remat=args.remat))
    modules = PipelineModules(config)
    if args.checkpoint_dir:
        modules.load_state_dicts(read_checkpoint_dir(args.checkpoint_dir), device=device)
    elif args.random_weights:
        modules.init_random(args.seed, device=device)
    else:
        raise SystemExit("give --checkpoint-dir or --random-weights")
    if args.resume_from_checkpoint:
        import_flat_adapter(modules.unet, load_flat_adapter(args.resume_from_checkpoint))
    else:
        init_adapter_from_text_kv(modules.unet)

    lr = args.learning_rate
    if args.scale_lr:  # the reference multiplies by accumulation, the per-rank batch and the world size
        lr *= args.gradient_accumulation_steps * args.train_batch_size * process_count()
    tc = TrainConfig(
        learning_rate=lr, lr_scheduler=args.lr_scheduler, lr_warmup_steps=args.lr_warmup_steps,
        adam_beta1=args.adam_beta1, adam_beta2=args.adam_beta2, adam_weight_decay=args.adam_weight_decay,
        adam_epsilon=args.adam_epsilon, use_8bit_adam=args.use_8bit_adam, max_grad_norm=args.max_grad_norm,
        gradient_accumulation_steps=args.gradient_accumulation_steps, max_train_steps=args.max_train_steps,
        checkpointing_steps=args.checkpointing_steps, validation_steps=args.validation_steps, seed=args.seed,
        snr_gamma=args.snr_gamma)

    dataset = AudioSetDataset(args.train_manifest, args.data_root, duration_s=args.duration, seed=args.seed)
    rank, world = process_index(), process_count()
    collate = DeviceCollate(modules, duration_s=args.duration, seed=args.seed, rank=rank, world=world)
    batches = data_loader(dataset, args.train_batch_size, collate, seed=args.seed, rank=rank, world=world)
    if args.dataloader_prefetch > 0:
        batches = prefetch(batches, depth=args.dataloader_prefetch)
    validation_fn = None
    if not args.no_validation and rank == 0:
        from ap_adapter_torch.train.validation import make_validation_fn

        # a dataset of its own: its caption draws leave the training stream's as they are
        val_dataset = AudioSetDataset(args.train_manifest, args.data_root, duration_s=args.duration,
                                      seed=args.seed)
        validation_fn = make_validation_fn(modules, val_dataset, args.output_dir, audio_length_in_s=args.duration,
                                           seed=args.seed, num_files=args.num_validation_audio_files)
    return train(modules, batches, tc, args.output_dir, validation_fn=validation_fn,
                 report_to=args.report_to, mesh=mesh), modules


if __name__ == "__main__":
    main()
