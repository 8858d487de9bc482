"""One rank of the port's CPU distributed tests (torch.distributed, gloo).

    python tests/torch_dist_worker.py <case> <rank> <world> <rendezvous file> <out dir>

``tests/test_torch_distributed.py`` and ``tests/test_torch_parallel.py``
start ``world`` of these at once; each joins the process group through a
``file://`` rendezvous (no port), runs every check of its ``case`` at the
tiny config in fp32, and writes what it computed to
``<out dir>/<case>_rank<rank>.npz`` for the test to hold against one
process. The same inputs come from the functions below, which the tests
import. Imports no JAX.

Cases: ``dp`` (2 ranks: ``replicate_params``, the data-parallel training
loop, with and without accumulation, the MAE pretraining step,
data-parallel generate), ``tp2`` (2
ranks: tensor-parallel generate over a (1, 2) mesh, and ``tasks.main
--tensor-parallel 2``), ``tp2dp2`` (4 ranks: generate over a (2, 2) mesh).
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ap_adapter_torch.configs import AudioMAEConfig, tiny_pipeline_config  # noqa: E402
from ap_adapter_torch.pipeline.pipeline import AudioLDM2Pipeline, PipelineModules, TextBatch  # noqa: E402

GLOBAL_B = 4          # the training batch of one process; each of 2 ranks holds 2 rows
STEPS = 2             # optimizer steps of each training run
MAE_TINY = AudioMAEConfig(img_size=(64, 32), patch_size=16, embed_dim=32, depth=2, num_heads=2,
                          decoder_embed_dim=16, decoder_depth=1, decoder_num_heads=2)
GENERATE = dict(audio_length_in_s=0.2, num_inference_steps=2, guidance_scale=3.0, ap_scale=0.5, time_pool=2,
                freq_pool=2, seed=0)


def tiny_modules() -> PipelineModules:
    return PipelineModules(tiny_pipeline_config()).init_random(seed=0, device="cpu")


def train_batches(accum: int) -> list:
    """The global micro-batches of ``STEPS`` optimizer steps, [GLOBAL_B, ...] each."""

    c = tiny_pipeline_config()
    rng = np.random.default_rng(accum)
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    mask = torch.ones(GLOBAL_B, 5, dtype=torch.long)
    mask[0, 3:] = 0
    return [{"mel": t(GLOBAL_B, 16, c.mel.num_mel_bins, 1) - 4.0,
             "generated_prompt_embeds": t(GLOBAL_B, 12, c.unet.adapter_cross_attention_dim),
             "prompt_embeds": t(GLOBAL_B, 5, c.t5.d_model), "attention_mask": mask}
            for _ in range(STEPS * accum)]


def train_config(accum: int):
    from ap_adapter_torch.train.trainer import TrainConfig

    return TrainConfig(learning_rate=1e-3, gradient_accumulation_steps=accum, checkpointing_steps=1,
                       max_train_steps=STEPS)


def mae_fbanks() -> torch.Tensor:
    """The fbank batches of ``STEPS`` MAE steps, [GLOBAL_B, T, F] each."""

    rng = np.random.default_rng(11)
    return torch.from_numpy(rng.standard_normal((STEPS, GLOBAL_B, *MAE_TINY.img_size)).astype(np.float32))


def mae_model():
    from ap_adapter_torch.models.mae_pretrain import MAEPretrain

    torch.manual_seed(0)
    return MAEPretrain(MAE_TINY)


def generate_inputs(b: int):
    """(pos, neg, fbank) of a global request batch of ``b`` rows, all different."""

    c = tiny_pipeline_config()
    rng = np.random.default_rng(7)

    def text():
        return TextBatch(rng.integers(2, c.clap.vocab_size, (b, 6)), np.ones((b, 6), np.int64),
                         rng.integers(2, c.t5.vocab_size, (b, 5)), np.ones((b, 5), np.int64))

    pos, neg = text(), text()
    return pos, neg, rng.standard_normal((b, *c.audiomae.img_size)).astype(np.float32)


def rows_of(text: TextBatch, start: int, n: int) -> TextBatch:
    return TextBatch(*(np.asarray(a)[start: start + n] for a in dataclasses.astuple(text)))


class Ranks:
    """The ``world`` ranks of ``case``, started at once (one thread each,
    writing under ``out_dir``); ``results()`` waits for them, so a caller
    computes its one-process reference while they run."""

    def __init__(self, case: str, world: int, out_dir: str):
        import subprocess

        self.case, self.out_dir, self._results = case, out_dir, None
        rendezvous = os.path.join(out_dir, f"rendezvous_{case}")
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), case, str(r), str(world),
                                        rendezvous, out_dir], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True, env=env)
                      for r in range(world)]

    def close(self) -> None:
        """Kill the ranks still running (a caller that never waited)."""

        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def results(self, timeout: float = 240.0) -> list:
        """Each rank's results, once every rank has exited 0; a rank that
        fails or hangs raises, with its output, and the others are killed."""

        if self._results is None:
            try:
                logs = [p.communicate(timeout=timeout)[0] for p in self.procs]
            finally:
                self.close()
            for r, (p, log) in enumerate(zip(self.procs, logs)):
                if p.returncode != 0:
                    raise RuntimeError(f"{self.case} rank {r} exited {p.returncode}:\n{log[-4000:]}")
            self._results = [dict(np.load(os.path.join(self.out_dir, f"{self.case}_rank{r}.npz")))
                             for r in range(len(self.procs))]
        return self._results


# -- the cases -------------------------------------------------------------------


def case_dp(mesh, out_dir: str) -> dict:
    from ap_adapter_torch.models.mae_pretrain import make_mae_pretrain_step
    from ap_adapter_torch.parallel.mesh import replicate_params, shard_batch
    from ap_adapter_torch.train.loop import train

    torch.manual_seed(mesh.coords["data"])                      # other weights on each rank...
    lin = torch.nn.Linear(3, 2)
    lin.register_buffer("scale", torch.rand(2))
    replicate_params(mesh, lin)                                 # ...then rank 0's everywhere
    out = {"replicated": torch.cat([lin.weight.detach().ravel(), lin.bias.detach(), lin.scale]).numpy()}
    validated = []                          # rank 0 alone validates, every step of the second run
    for accum in (1, 2):
        mods = tiny_modules()
        local = [shard_batch(mesh, mb) for mb in train_batches(accum)]
        tc = dataclasses.replace(train_config(accum), validation_steps=1 if accum == 2 else STEPS + 1)
        state = train(mods, iter(local), tc, os.path.join(out_dir, f"train_accum{accum}"), log_every=1,
                      validation_fn=validated.append if mesh.coords["data"] == 0 else None, mesh=mesh)
        out[f"accum{accum}/loss"] = [m["loss"] for m in state.history]
        out[f"accum{accum}/grad_norm"] = [m["grad_norm"] for m in state.history]
        for k, p in state.adapter.items():
            out[f"accum{accum}/adapter/{k}"] = p.detach().numpy()
            out[f"accum{accum}/grad/{k}"] = p.grad.numpy()          # the last step's, all-reduced and clipped

    out["validated"] = validated

    model = mae_model()
    step = make_mae_pretrain_step(model, torch.optim.AdamW(model.parameters(), lr=1e-3), mesh=mesh)
    gen = torch.Generator().manual_seed(5)
    out["mae/loss"] = [step(shard_batch(mesh, fb), gen).item() for fb in mae_fbanks()]
    for k, v in model.state_dict().items():
        out[f"mae/weights/{k}"] = v.numpy()

    pipe = AudioLDM2Pipeline(tiny_pipeline_config(), tiny_modules(), mesh=mesh)
    pos, neg, fbank = generate_inputs(2)
    r = mesh.coords["data"]
    out["generate"] = pipe.generate(rows_of(pos, r, 1), rows_of(neg, r, 1), fbank[r: r + 1], **GENERATE)
    return out


def case_tp(mesh, out_dir: str) -> dict:
    from ap_adapter_torch.parallel.tp import count_sharded_leaves

    pipe = AudioLDM2Pipeline(tiny_pipeline_config(), tiny_modules(), mesh=mesh, tensor_parallel=True)
    pos, neg, fbank = generate_inputs(mesh.shape["data"] * 2)
    start, _ = mesh.rows(2)
    out = {"generate": pipe.generate(rows_of(pos, start, 2), rows_of(neg, start, 2), fbank[start: start + 2],
                                     **GENERATE),
           "sharded": count_sharded_leaves(pipe.modules.unet),
           "to_q_rows": pipe.modules.unet.down_blocks[1].attentions[1].transformer_blocks[0].attn1.to_q.weight.shape[0],
           "force_xla_core": pipe.config.unet.force_xla_core}
    if mesh.shape["data"] == 1:
        from ap_adapter_torch.pipeline import tasks

        rank_dir = os.path.join(out_dir, f"tasks_rank{mesh.coords['model']}")
        paths = tasks.main(["--task", "timbre_transfer", "--tiny", "--random-weights", "--tensor-parallel", "2",
                            "--audio-prompt", os.path.join(out_dir, "source.wav"), "--output-dir", rank_dir,
                            "--num-files", "1", "--steps", "2", "--audio-length", "0.2", "--prompt", "trumpet",
                            "--time-pool", "2", "--freq-pool", "2", "--device", "cpu"])
        out["task_paths"] = np.array(paths)
    return out


def main() -> None:
    case, rank, world, rendezvous, out_dir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
    torch.set_num_threads(1)
    os.environ.update(APX_NUM_PROCESSES=str(world), APX_PROCESS_ID=str(rank))

    from ap_adapter_torch.parallel.distributed import maybe_initialize
    from ap_adapter_torch.parallel.mesh import create_mesh

    assert maybe_initialize(device="cpu", init_method=f"file://{rendezvous}")
    if case == "dp":
        out = case_dp(create_mesh(device="cpu"), out_dir)
    else:
        out = case_tp(create_mesh(data=world // 2, model=2, device="cpu"), out_dir)
    np.savez(os.path.join(out_dir, f"{case}_rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
