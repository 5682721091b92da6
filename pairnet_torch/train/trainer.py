"""Training: the train step, the val step and the epoch runner.

Counterpart of ``pairnet_tpu/train/trainer.py``, on one device or data
parallel over the default process group (``parallel/mesh.py``):

* :class:`TrainState`: step, the f32 master model, its AdamW optimizer, the
  Seesaw ``cum_samples`` and a generator seeded 10086 (the reference's seed);
* :func:`make_train_step`: forward in train mode, on-device targets, the
  head's losses (``dispatch.get_loss_fn``; Pair-Net's targets are built
  apart, the other heads' inside their loss), backward, optax's global-norm clip (over every gradient,
  the frozen stem's included) and the AdamW step. With
  ``compute_dtype=torch.bfloat16`` the forward runs on bf16 copies of every
  f32 parameter and buffer and a bf16 image, and its outputs are cast back
  to f32 before the loss; autograd through the casts returns f32 gradients
  to the f32 masters;
* :class:`Trainer`: ``fit`` / ``train_epoch`` / ``val_epoch``, checkpoints
  with ``torch.save`` and keep-rotation, ``resume``, the NaN guard
  (``PAIRNET_DEBUG_NANS``) and the profiler knob (``PAIRNET_PROFILE_DIR``:
  ``torch.profiler`` traces iterations 2-4 of epoch 0 into that directory,
  with the port's spans on: ``utils/tracing.py``).

Randomness: each step draws two seeds from the state's generator, one for
the mask-cost sampling points and one for the device's default generator,
which dropout reads, seeded inside ``torch.random.fork_rng``.
Nothing of a step reaches the host inside the step on the card: the
target building's Hungarian runs as a kernel there (``ops/hungarian.py``).

Data parallelism computes JAX's sharded step, the step of the global batch:
each rank holds ``B / world`` rows and the same generator; the points are
drawn for the global batch and each rank keeps its rows; dropout's seed
adds the rank; every loss normalizer is the global batch's (the losses'
``reduce``), so each rank's loss is its share of the global loss and the
gradients are SUMMED across ranks, in one coalesced all-reduce before the
clip (JAX's psum), after which AdamW leaves the parameters equal on every
rank. The logged losses are summed across ranks: the global loss.
"""

from __future__ import annotations

import logging
import os
import re
import time
from pathlib import Path
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.func import functional_call

from pairnet_torch.models.heads.pairnet_loss import pairnet_targets
from pairnet_torch.parallel.mesh import (
    all_reduce_coalesced,
    all_reduce_sum,
    is_distributed,
    world_info,
)
from pairnet_torch.train.dispatch import TWO_STAGE, get_loss_fn
from pairnet_torch.train.optim import GRAD_CLIP, clip_by_global_norm, set_lr
from pairnet_torch.utils import tracing

logger = logging.getLogger("pairnet_torch")
SEED = 10086


class TrainState:
    """Everything a step reads and advances. ``model`` holds the f32 master
    weights; ``generator`` is a CPU generator, so drawing seeds from it
    needs no device sync."""

    def __init__(self, model, optimizer, num_relations: int, seed: int = SEED):
        device = next(model.parameters()).device
        self.step = 0
        self.model = model
        self.optimizer = optimizer
        self.cum_samples = torch.zeros((num_relations,), device=device)
        self.generator = torch.Generator().manual_seed(seed)

    @property
    def device(self) -> torch.device:
        return self.cum_samples.device

    KEYS = ("step", "model", "optimizer", "cum_samples", "generator")

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "cum_samples": self.cum_samples,
                "generator": self.generator.get_state()}

    def load_state_dict(self, sd: dict) -> None:
        self.step = int(sd["step"])
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.cum_samples = sd["cum_samples"].to(self.device)
        self.generator.set_state(sd["generator"].cpu())


def _draw_seeds(generator, n: int) -> list[int]:
    return torch.randint(0, 2 ** 62, (n,), generator=generator).tolist()


def sample_points(batch_size: int, num_points: int, seed: int, device) -> torch.Tensor:
    """(B, P, 2) uniform points in [0, 1] for the mask costs."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((batch_size, num_points, 2), generator=g, device=device)


def _reducer():
    """The losses' ``reduce``: None (world size 1) without a process group."""
    return all_reduce_sum if is_distributed() else None


def _rank_points(batch_size, num_points, seed, device):
    """The points of this rank's rows of the global batch."""
    rank, world = world_info()
    points = sample_points(batch_size * world, num_points, seed, device)
    return points[rank * batch_size : (rank + 1) * batch_size]


def _upcast_masks(batch: dict) -> dict:
    """The loader ships bool mask canvases; the losses want f32."""
    if batch["gt_masks"].dtype == torch.bool:
        batch = dict(batch, gt_masks=batch["gt_masks"].float())
    return batch


def upcast(tree, dtype):
    """The tensors of ``tree`` (nested dicts and lists) in ``dtype`` as f32."""
    if isinstance(tree, dict):
        return {k: upcast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(upcast(v, dtype) for v in tree)
    return tree.float() if tree.dtype == dtype else tree


def forward(model, inputs, compute_dtype=None):
    """The model's forward on ``inputs`` (an image, or a two-stage model's
    batch dict), in ``compute_dtype`` if given: bf16 copies of every f32
    parameter and buffer, a bf16 image, f32 outputs."""
    if compute_dtype is None:
        return model(inputs)
    tensors = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    cast = {n: t.to(compute_dtype) if t.dtype == torch.float32 else t for n, t in tensors.items()}
    if isinstance(inputs, dict):
        inputs = dict(inputs, image=inputs["image"].to(compute_dtype))
    else:
        inputs = inputs.to(compute_dtype)
    return upcast(functional_call(model, cast, (inputs,)), compute_dtype)


def model_inputs(batch: dict, head_type: str):
    """What the model's forward takes: the image, or the whole batch for a
    two-stage relation head (boxes, labels and pairs ride in it)."""
    return batch if head_type in TWO_STAGE else batch["image"]


PHASES = ("forward", "targets", "loss", "backward", "optimizer")


def make_train_step(model, optimizer, loss_kwargs: dict | None = None, compute_dtype=None,
                    schedule: Callable[[int], float] | None = None,
                    on_phase: Callable[[str], None] | None = None,
                    grad_clip: float = GRAD_CLIP, head_type: str = "PairNetHead"):
    """The train step ``(state, batch) -> metrics``: advances ``state`` in
    place and returns the losses and ``grad_norm`` (the pre-clip global
    norm) as device tensors. ``batch`` holds device tensors: ``image``
    (B, H, W, 3) and the padded GT (``gt_labels``, ``gt_masks``,
    ``gt_valid``, ``gt_rels``, ``rel_valid``). ``loss_kwargs`` are the
    config's ``loss`` options. ``schedule`` maps the step to the base lr;
    without it the optimizer's lr stays as built. ``on_phase(name)`` is
    called at the end of each of ``PHASES`` (a profiling hook: the
    benchmark records a CUDA event there). The step is the unit span
    ``train.step``, each phase a span ``train.<phase>`` of it
    (``utils/tracing.py``). ``grad_clip`` is the max global norm.
    ``head_type`` picks the loss (``dispatch.get_loss_fn``); the DETR heads'
    losses also read the batch's ``gt_boxes`` and ``image_shape``.
    With a process group, ``batch`` is this rank's rows of the global batch
    and the step is data parallel over the world."""
    loss_fn = get_loss_fn(head_type, {"loss": loss_kwargs or {}}, reduce=_reducer())
    pairnet = head_type == "PairNetHead"
    num_points = loss_fn.num_points
    params = list(model.parameters())
    mark = on_phase or (lambda name: None)
    rank = world_info()[0]

    def train_step(state: TrainState, batch: dict) -> dict:
        with tracing.unit("train.step"):
            return step(state, batch)

    def step(state: TrainState, batch: dict) -> dict:
        with tracing.span("train.forward"):
            batch = _upcast_masks(batch)
            image = batch["image"]
            points_seed, dropout_seed = _draw_seeds(state.generator, 2)
            points = _rank_points(image.shape[0], num_points, points_seed, image.device)
            dropout_seed += rank  # ranks draw their own dropout masks
            if schedule is not None:
                set_lr(optimizer, schedule(state.step))
            model.train()
            devices = [image.device] if image.device.type == "cuda" else []
            with torch.random.fork_rng(devices=devices, device_type="cuda"):
                if devices:
                    with torch.cuda.device(image.device):
                        torch.cuda.manual_seed(dropout_seed)
                else:
                    torch.random.default_generator.manual_seed(dropout_seed)
                out = forward(model, model_inputs(batch, head_type), compute_dtype)
        mark("forward")
        with tracing.span("train.targets"):
            targets = pairnet_targets(out, batch, points) if pairnet else None
        mark("targets")
        with tracing.span("train.loss"):
            losses, new_cum = loss_fn(out, batch, points, state.cum_samples, targets=targets)
        mark("loss")
        with tracing.span("train.backward"):
            optimizer.zero_grad(set_to_none=False)
            losses["loss_total"].backward()
        mark("backward")
        with tracing.span("train.optimizer"):
            for p in params:  # a parameter the loss never reads has gradient 0, as in JAX
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            all_reduce_coalesced([p.grad for p in params])  # the global batch's gradient
            grad_norm = clip_by_global_norm([p.grad for p in params], grad_clip)
            optimizer.step()
        mark("optimizer")
        state.cum_samples = new_cum
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        all_reduce_coalesced(list(metrics.values()))  # the global losses
        metrics["grad_norm"] = grad_norm
        return metrics

    return train_step


def make_val_step(model, loss_kwargs: dict | None = None, head_type: str = "PairNetHead"):
    """The val step ``(state, batch) -> losses``: deterministic f32 forward,
    the same losses, no gradient and no change to the state. Its points
    come from a copy of the state's generator. With a process group each
    rank's losses are its shares of the global batch's (summed by
    ``Trainer.val_epoch``)."""
    loss_fn = get_loss_fn(head_type, {"loss": loss_kwargs or {}}, reduce=_reducer())

    @torch.no_grad()
    def val_step(state: TrainState, batch: dict) -> dict:
        batch = _upcast_masks(batch)
        image = batch["image"]
        g = torch.Generator().set_state(state.generator.get_state())
        points = _rank_points(image.shape[0], loss_fn.num_points, _draw_seeds(g, 1)[0],
                              image.device)
        model.eval()
        losses, _ = loss_fn(model(model_inputs(batch, head_type)), batch, points,
                            state.cum_samples)
        return losses

    return val_step


def to_device(batch: dict, device) -> dict:
    """A host batch (numpy arrays) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


def write_checkpoint(path: Path, epoch: int, state: dict) -> Path:
    """``{"epoch", "state"}`` into ``path`` (``ckpts/epoch_<n>.pt``), through a
    temporary file, so a reader never sees a partial one."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    torch.save({"epoch": epoch, "state": state}, tmp)
    os.replace(tmp, path)
    return path


class Trainer:
    """Epoch runner: train, optional val pass and eval hook, checkpoints
    with keep-rotation, resume. Trains ``state.model`` with
    ``state.optimizer`` and advances ``state`` in place. Data parallel over
    the default process group when there is one: the loaders hand each rank
    its rows, rank 0 writes the checkpoints (the others wait at a barrier)
    and alone runs the profiler, every rank resumes from the same file, the
    NaN guard's decision is summed over the ranks so they raise together,
    and the val sums are summed over the ranks."""

    def __init__(self, state: TrainState, work_dir: str, loss_kwargs: dict | None = None,
                 log_interval: int = 50, ckpt_interval_epochs: int = 1,
                 max_keep_ckpts: int = 15, compute_dtype=None,
                 schedule: Callable[[int], float] | None = None, grad_clip: float = GRAD_CLIP,
                 head_type: str = "PairNetHead"):
        self.state = state
        self.ckpt_dir = Path(work_dir) / "ckpts"
        self.log_interval = log_interval
        self.ckpt_interval_epochs = ckpt_interval_epochs
        self.max_keep_ckpts = max_keep_ckpts
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.rank = world_info()[0]
        self._step_fn = make_train_step(state.model, state.optimizer, loss_kwargs, compute_dtype,
                                        schedule, grad_clip=grad_clip, head_type=head_type)
        self._val_fn = make_val_step(state.model, loss_kwargs, head_type)

    def checkpoints(self) -> list[tuple[int, Path]]:
        found = []
        for p in self.ckpt_dir.glob("epoch_*.pt"):
            m = re.fullmatch(r"epoch_(\d+)\.pt", p.name)
            if m:
                found.append((int(m.group(1)), p))
        return sorted(found)

    def resume(self) -> int:
        """Load the latest checkpoint if there is one; returns its epoch."""
        ckpts = self.checkpoints()
        if not ckpts:
            return 0
        epoch, path = ckpts[-1]
        sd = torch.load(path, map_location=self.state.device, weights_only=False)
        missing = [k for k in TrainState.KEYS if k not in sd["state"]]
        if missing:
            raise ValueError(f"cannot resume from {path}: the checkpoint holds no "
                             f"{', '.join(missing)}: it carries weights only (as the import of a "
                             "params-only JAX export does), which the test CLI scores and "
                             "--load-from reads; a resume needs the whole training state")
        self.state.load_state_dict(sd["state"])
        logger.info("resumed from %s", path)
        return epoch

    def save(self, epoch: int) -> Path:
        """Write the state as ``ckpts/epoch_<n>.pt``, keeping the newest
        ``max_keep_ckpts``; rank 0 writes, every rank returns after it."""
        path = self.ckpt_dir / f"epoch_{epoch}.pt"
        if self.rank == 0:
            write_checkpoint(path, epoch, self.state.state_dict())
            for _, old in self.checkpoints()[: -self.max_keep_ckpts]:
                old.unlink()
        if is_distributed():
            dist.barrier()
        return path

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.state.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        tracing.enable(True)  # the traced iterations name the port's layers
        prof.start()
        return prof

    def _stop_profile(self, prof, profile_dir: str, epoch: int, first: int, last: int) -> Path:
        if self.state.device.type == "cuda":
            torch.cuda.synchronize(self.state.device)
        prof.stop()
        tracing.enable(False)
        path = Path(profile_dir) / f"trace_epoch{epoch}_iter{first}-{last}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        logger.info("profiler trace written to %s", path)
        return path

    def train_epoch(self, loader, epoch: int) -> dict:
        t0 = time.time()
        last = {}
        nan_check = bool(os.environ.get("PAIRNET_DEBUG_NANS"))
        # with PAIRNET_PROFILE_DIR set, trace iterations 2-4 of epoch 0
        # (past the first steps' allocations and kernel builds)
        profile_dir = os.environ.get("PAIRNET_PROFILE_DIR")
        prof = None
        for i, batch in enumerate(loader):
            if profile_dir and epoch == 0 and i == 2 and self.rank == 0:
                prof = self._start_profile()
            batch = to_device(batch, self.state.device)
            metrics = self._step_fn(self.state, batch)
            if prof is not None and i == 4:
                self._stop_profile(prof, profile_dir, epoch, 2, i)
                prof = None
            if nan_check:
                bad = {k: float(v) for k, v in metrics.items() if not float(v) == float(v)}
                flag = torch.tensor([float(len(bad))], device=self.state.device)
                if float(all_reduce_sum(flag)) > 0:  # every rank raises, or none
                    raise FloatingPointError(f"NaN losses at epoch {epoch} iter {i}: {bad}")
            if (i + 1) % self.log_interval == 0 or i == 0:
                last = {k: float(v) for k, v in metrics.items()}
                logger.info("epoch %d iter %d time %.3fs %s", epoch, i + 1,
                            (time.time() - t0) / (i + 1),
                            " ".join(f"{k}={v:.4f}" for k, v in last.items()))
        if prof is not None:  # the epoch ended inside the window
            self._stop_profile(prof, profile_dir, epoch, 2, i)
        return last

    def val_epoch(self, loader, epoch: int) -> dict:
        """Validation-loss pass (the reference's ('val', 1) workflow leg)."""
        sums: dict = {}
        n = 0
        for batch in loader:
            losses = self._val_fn(self.state, to_device(batch, self.state.device))
            for k, v in losses.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        if sums and is_distributed():  # each rank summed its shares of the global losses
            total = torch.tensor(list(sums.values()), dtype=torch.float64,
                                 device=self.state.device)
            sums = dict(zip(sums, all_reduce_sum(total).tolist()))
        means = {f"val_{k}": v / max(n, 1) for k, v in sums.items()}
        logger.info("epoch %d val %s", epoch, " ".join(f"{k}={v:.4f}" for k, v in means.items()))
        return means

    def fit(self, loader_fn: Callable[[int], Any], max_epochs: int,
            val_loader_fn: Callable[[int], Any] | None = None,
            eval_hook: Callable[[TrainState, int], dict] | None = None,
            eval_interval: int = 1, resume: bool = True) -> dict:
        """Per epoch: train, then the optional val pass, a checkpoint every
        ``ckpt_interval_epochs``, then the optional eval hook every
        ``eval_interval`` epochs. Starts from the latest checkpoint, or at
        epoch 0 with ``resume=False``; ``start_epoch`` records where."""
        start = self.resume() if resume else 0
        self.start_epoch = start
        last = {}
        for epoch in range(start, max_epochs):
            last = self.train_epoch(loader_fn(epoch), epoch)
            if val_loader_fn is not None:
                last.update(self.val_epoch(val_loader_fn(epoch), epoch))
            if (epoch + 1) % self.ckpt_interval_epochs == 0:
                self.save(epoch + 1)
            if eval_hook is not None and (epoch + 1) % eval_interval == 0:
                last.update(eval_hook(self.state, epoch))
        return last
