"""Training engine: the epoch loop, validation, the full-inference
validation, checkpoints and the metrics log of one experiment, on one
device or data-parallel over a ``parallel.World`` (torch port of
deftet_tpu/train/engine.py).

``Engine(config)`` runs on the GPU.  ``device="cpu"`` runs every kernel's
plain PyTorch version instead, as the tests do.  Asking for CUDA without
a GPU raises; nothing falls back silently.

Without ``statics`` the engine builds the regular res-``config.res`` Kuhn
grid; given ``statics`` (``build_grid_statics(res, grid=...)`` of any tet
grid, e.g. one read by ``read_tet_file``) it runs on them.  Their lattice
layout picks the stencil and slice fast paths, or else the gather paths,
as in the JAX package.

The experiment directory (config, state, ``metrics.jsonl``, ``ckpt/``)
is created at the first write, so an engine that only takes steps writes
nothing.  A checkpoint holds the model's parameters and BatchNorm
statistics, the optimizer's moments and count, and the engine's generator,
so a restored engine draws what the uninterrupted one would.

``Engine(config, world=init_world(...))`` trains data-parallel: rank r
runs on the world's device for it, takes its rows of every global batch
(``_prep_batch``), and every step, validation and inference validation
computes the one-process numbers of the global batch (the step's
collectives run over the first ``largest_divisor(world.size,
batch_size)`` ranks; a rank past them is idle and ``fit`` returns at
once).  The parameters and buffers start as rank 0's.  Only rank 0
writes (metrics, config, state, checkpoints, OBJs); ``restore`` loads on
rank 0 and broadcasts to the step's ranks.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from .. import parallel
from ..config import Experiment, TrainConfig
from ..nn import DeformableTetNetwork
from ..utils import timing
from ..utils.timing import span
from .checkpoint import restore_checkpoint, save_checkpoint
from .statics import GridStatics, build_grid_statics, statics_to
from .step import eval_step, forward_losses, make_optimizer, train_step


def check_supported(config: TrainConfig) -> None:
    """Raise NotImplementedError naming the options the port refuses."""
    unsupported = {
        # asserted off by the JAX package too
        "use_graph_attention": config.use_graph_attention,
        "occ_source": config.occ_source not in ("grid", "check_sign"),
        "precision": config.precision not in ("bf16", "f32"),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"not supported by the port: {bad}")


class Engine:
    """Owns the statics, model, optimizer and generator of one run."""

    def __init__(self, config: TrainConfig, device="cuda",
                 experiment: Optional[Experiment] = None,
                 statics: Optional[GridStatics] = None,
                 world: Optional[parallel.World] = None):
        check_supported(config)
        self.world = world
        self.shard = None
        if world is not None:
            device = world.device
            self.shard = world.shard(config.batch_size)
            if self.shard is not None:
                accum = max(int(config.grad_accum), 1)
                m, n = config.batch_size // accum, self.shard.size
                if m % n:
                    raise ValueError(
                        f"grad_accum={accum}: a microbatch of {m} rows "
                        f"(batch_size {config.batch_size}) does not split "
                        f"over {n} ranks")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("Engine(device='cuda') needs a CUDA "
                                   "device; pass device='cpu' to run on "
                                   "the CPU")
            # float32 means float32, as in the JAX package: cuDNN would
            # otherwise run float32 convolutions in TF32 (matmuls already
            # default to full float32).  Process-wide settings.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self._experiment = experiment
        with span("engine.init"):
            with span("engine.statics"):
                if statics is not None:
                    self.statics = statics_to(statics, self.device)
                else:
                    # the lattice's face-derived gather tables are read
                    # only by the uncompacted normal term
                    budget = config.resolved_max_boundary_faces()
                    self.statics = build_grid_statics(
                        config.res, device=self.device,
                        face_arrays=not 0 < budget < 12 * config.res**3)
            with span("engine.model"):
                init_gen = torch.Generator().manual_seed(config.seed)
                self.model = DeformableTetNetwork(
                    blocks=config.parsed_blocks(),
                    use_two_encoder=config.use_two_encoder,
                    use_lap_layer=config.use_lap_layer,
                    scale_pos=config.scale_pos,
                    scale_pvcnn=config.scale_pvcnn,
                    train_def=config.train_def,
                    gcn_hidden=config.parsed_gcn_hidden(),
                    pos_mlp_hidden=config.parsed_pos_mlp_hidden(),
                    occ_mlp_hidden=config.parsed_occ_mlp_hidden(),
                    dtype=(torch.bfloat16 if config.precision == "bf16"
                           else None),
                    use_disn=config.use_disn,
                    disn_image_size=config.disn_image_size,
                    disn_local_feature_size=config.disn_local_feature_size,
                    disn_encoding_dim=config.disn_encoding_dim,
                    disn_width=config.disn_width,
                    generator=init_gen,
                ).to(self.device)
                if config.pretrain:
                    # warm start from another experiment's best checkpoint:
                    # parameters and BatchNorm statistics, a fresh optimizer
                    tree = restore_checkpoint(
                        os.path.join(config.pretrain, "ckpt"), "best",
                        map_location="cpu")
                    self.model.load_state_dict(tree["model"])
                if world is not None:
                    parallel.replicate(self.model)
                self.optimizer = make_optimizer(
                    config, list(self.model.parameters()))
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.seed + 1)
        self._infer_step = None  # built at the first inference validation
        # config.timing: spans record CUDA events, and save() writes
        # their summary (utils/timing.py)
        timing.RECORDER.device_events = bool(config.timing)
        self.global_step = 0
        self.best_iou = 0.0
        self.epoch = 0

    # ------------------------------------------------------------------ util
    @property
    def is_main(self) -> bool:
        """True on the rank that writes (rank 0, or the one process)."""
        return self.world is None or self.world.rank == 0

    @property
    def idle(self) -> bool:
        """True on a rank past the divisor clamp: it takes no rows."""
        return self.world is not None and self.shard is None

    @property
    def experiment(self) -> Experiment:
        if not self.is_main:
            raise RuntimeError("only rank 0 writes the experiment")
        if self._experiment is None:
            self._experiment = Experiment.new(self.config)
        return self._experiment

    def _log(self, record: Dict) -> None:
        if not self.is_main:
            return
        with span("engine.log"), open(
                self.experiment.file_path("metrics.jsonl"), "a") as f:
            f.write(json.dumps(record) + "\n")

    def _prep_batch(self, batch: Dict[str, np.ndarray],
                    microbatches: Optional[int] = None):
        """Numeric batch entries as tensors on the engine's device; under
        a world, this rank's rows of the global batch, laid out for
        ``microbatches`` (default ``grad_accum``: the train step's; the
        validations pass 1)."""
        with span("engine.prep_batch"):
            out = {}
            for k, v in batch.items():
                if isinstance(v, torch.Tensor):
                    out[k] = v
                elif isinstance(v, np.ndarray) and (
                        np.issubdtype(v.dtype, np.number)
                        or np.issubdtype(v.dtype, np.bool_)):
                    out[k] = v
            if self.shard is not None:
                accum = max(int(self.config.grad_accum), 1)
                out = parallel.shard_rows(out, self.shard.index,
                                          self.shard.size,
                                          microbatches or accum)
            return {k: torch.as_tensor(v).to(self.device)
                    for k, v in out.items()}

    def _sharded(self):
        """The context of one step: this rank's shard of the global batch
        (nothing in one process)."""
        if self.idle:
            raise RuntimeError(f"rank {self.world.rank} takes no part in a "
                               f"batch of {self.config.batch_size}")
        return parallel.sharded(self.shard)

    def _save_vis(self, batch, name: str) -> None:
        from ..evals.harness import save_predicted_surface_objs

        save_predicted_surface_objs(
            self.model, batch, self.statics, self.config,
            self.experiment.file_path(name))

    # ----------------------------------------------------------------- train
    def train_step(self, batch, draws=None) -> Dict[str, torch.Tensor]:
        """One optimizer update on a prepared batch; returns the terms
        (of the global batch, under a world; ``draws`` then at the global
        shape)."""
        with self._sharded():
            terms = train_step(self.model, self.optimizer, batch,
                               self.statics, self.config, self.generator,
                               draws=draws)
        self.global_step += 1
        return terms

    def forward_losses(self, batch, train: bool = True, draws=None):
        """(total, terms) without an update (for gradients or parity);
        under a world, this rank's part (its rows' means)."""
        with self._sharded():
            return forward_losses(self.model, batch, self.statics,
                                  self.config, self.generator, train=train,
                                  draws=draws)

    def train_epoch(self, batches: Iterator[Dict[str, np.ndarray]]) -> Dict:
        """One epoch over numpy batches; returns the mean terms.  The sums
        stay on the device: the host reads them only where it logs."""
        with span("engine.train_epoch"):
            dev_sums = None
            n = 0
            batches = iter(batches)
            while True:
                with span("engine.next_batch"):
                    batch = next(batches, None)
                if batch is None:
                    break
                prepped = self._prep_batch(batch)
                terms = self.train_step(prepped)
                n += 1
                self._report(terms, n)
                if (self.config.save_vis and self.config.save_vis_every
                        and self.is_main and self.global_step
                        % self.config.save_vis_every == 0):
                    self._save_vis(prepped, f"vis_{self.global_step}")
                dev_sums = (dict(terms) if dev_sums is None else
                            {k: dev_sums[k] + v for k, v in terms.items()})
            self.epoch += 1
            with span("engine.read"):
                return {k: float(v) / max(n, 1)
                        for k, v in (dev_sums or {}).items()}

    def _report(self, terms, n: int) -> None:
        """Log the ``n``-th update of the epoch's terms (its first and
        every tenth global step) and print them every ``print_every``."""
        want_log = self.global_step % 10 == 0 or n == 1
        want_print = (self.config.print_every
                      and self.global_step % self.config.print_every == 0)
        if not (want_log or want_print):
            return
        with span("engine.read"):
            host = {k: float(v) for k, v in terms.items()}
        if want_log:
            self._log({"kind": "train", "step": self.global_step, **host})
        if want_print and self.is_main:
            print(f"step {self.global_step} "
                  f"total={host.get('total', 0.0):.4f} "
                  f"occ={host.get('occ', 0.0):.4f} "
                  f"occ_iou={host.get('occ_iou', 0.0):.4f}", flush=True)

    # ------------------------------------------------------------------ eval
    def validate(self, batches: Iterator[Dict[str, np.ndarray]]) -> Dict:
        """Mean validation terms, ``occ_iou`` included.  With save_vis the
        first batch's predicted surfaces are written as OBJs."""
        sums: Dict[str, torch.Tensor] = {}
        n = 0
        for batch in batches:
            prepped = self._prep_batch(batch, microbatches=1)
            if n == 0 and self.config.save_vis and self.is_main:
                self._save_vis(prepped, f"vis_{self.global_step}")
            with self._sharded():
                terms = eval_step(self.model, prepped, self.statics,
                                  self.config, self.generator)
            for k, v in terms.items():
                sums[k] = sums[k] + v if k in sums else v
            n += 1
        if n == 0:
            raise ValueError(
                "validate() received no batches — check that the validation "
                "split has at least batch_size examples")
        with span("engine.read"):
            means = {k: float(v) / n for k, v in sums.items()}
        self._log({"kind": "val", "step": self.global_step, **means})
        return means

    def inference_step(self):
        """The full-inference step of this engine's model (built once)."""
        if self._infer_step is None:
            from ..evals.harness import make_inference_step

            self._infer_step = make_inference_step(self.model, self.config)
        return self._infer_step

    def validate_inference(self, batches: Iterator[Dict[str, np.ndarray]]):
        """Means of the full-inference metrics, ``val_iou_max`` (the
        selection metric) included; None if the batches carry no SDF
        samples."""
        sums: Dict[str, torch.Tensor] = {}
        n = 0
        for batch in batches:
            if "sdf_points" not in batch:
                return None
            prepped = self._prep_batch(batch, microbatches=1)
            with self._sharded():
                terms = self.inference_step()(prepped, self.statics,
                                              self.generator)
            for k, v in terms.items():
                sums[k] = sums[k] + v if k in sums else v
            n += 1
        if n == 0:
            return None
        with span("engine.read"):
            means = {k: float(v) / n for k, v in sums.items()}
        self._log({"kind": "val_inference", "step": self.global_step,
                   **means})
        return means

    # ------------------------------------------------------------ checkpoint
    def save(self, best: bool = False) -> None:
        """Checkpoint ``last`` (and ``best``) and the state; rank 0
        only."""
        if not self.is_main:
            return
        tree = {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.optimizer.count,
            "generator": self.generator.get_state(),
        }
        ckdir = self.experiment.file_path("ckpt")
        save_checkpoint(ckdir, "last", tree)
        if best:
            save_checkpoint(ckdir, "best", tree)
        self.experiment.write_state({"epoch": self.epoch,
                                     "best_iou": self.best_iou,
                                     "global_step": self.global_step})
        if self.config.timing:
            timing.RECORDER.save(self.experiment.file_path("timing.json"))

    def restore(self, name: str = "last") -> None:
        """Load checkpoint ``name``; under a world, rank 0 loads and
        broadcasts to the step's ranks (each calls it; an idle rank does
        nothing)."""
        if self.idle:
            return
        meta = None
        if self.is_main:
            tree = restore_checkpoint(self.experiment.file_path("ckpt"),
                                      name, map_location="cpu")
            self.model.load_state_dict(tree["model"])
            self.optimizer.load_state_dict(tree["optimizer"])
            self.generator.set_state(tree["generator"])
            st = self.experiment.read_state()
            meta = {"count": self.optimizer.count,
                    "generator": self.generator.get_state(),
                    "epoch": int(st.get("epoch", 0)),
                    "best_iou": float(st.get("best_iou", 0.0)),
                    "global_step": int(st.get("global_step", 0))}
        if self.world is not None:
            group = self.shard.group
            parallel.replicate(list(self.model.parameters())
                               + list(self.model.buffers())
                               + self.optimizer.mu + self.optimizer.nu,
                               group=group)
            box = [meta]
            torch.distributed.broadcast_object_list(
                box, src=0, group=group, device=self.device)
            meta = box[0]
            self.optimizer.count = meta["count"]
            self.generator.set_state(meta["generator"])
        self.epoch = meta["epoch"]
        self.best_iou = meta["best_iou"]
        self.global_step = meta["global_step"]

    # ------------------------------------------------------------------- fit
    def fit(self, train_iter_fn, val_iter_fn, epochs: Optional[int] = None):
        """Epochs of training, each validated every ``val_every`` epochs
        and checkpointed, ``best`` chosen by ``val_iou_max`` of the
        inference validation (``occ_iou`` without SDF samples)."""
        epochs = epochs if epochs is not None else self.config.epochs
        history = []
        if self.idle:
            return history
        for _ in range(epochs):
            # host seconds of each part's span (each ends reading its
            # means back, so the device's work is inside it), logged as an
            # "epoch" line
            train_means = self.train_epoch(train_iter_fn())
            seconds = {"train_s": timing.RECORDER.last("engine.train_epoch")}
            record = {"epoch": self.epoch, "train": train_means}
            if self.epoch % self.config.val_every == 0:
                with span("engine.validate") as t:
                    val_means = self.validate(val_iter_fn())
                seconds["val_s"] = t.seconds
                record["val"] = val_means
                with span("engine.validate_inference") as t:
                    inf_means = (self.validate_inference(val_iter_fn())
                                 if self.config.val_inference else None)
                seconds["val_inference_s"] = t.seconds
                if inf_means is not None:
                    record["val_inference"] = inf_means
                    val_iou = inf_means["val_iou_max"]
                else:
                    val_iou = val_means.get("occ_iou", 0.0)
                is_best = val_iou > self.best_iou
                if is_best:
                    self.best_iou = val_iou
                with span("engine.save") as t:
                    self.save(best=is_best)
                seconds["save_s"] = t.seconds
            if self.device.type == "cuda":
                seconds["peak_bytes"] = torch.cuda.max_memory_allocated(
                    self.device)
            self._log({"kind": "epoch", "epoch": self.epoch,
                       "step": self.global_step, **seconds})
            history.append(record)
        return history
