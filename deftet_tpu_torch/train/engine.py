"""Training engine: the epoch loop, validation, the full-inference
validation, checkpoints and the metrics log of one experiment, on one
device (torch port of deftet_tpu/train/engine.py).

``Engine(config)`` runs on the GPU.  ``device="cpu"`` runs every kernel's
plain PyTorch version instead, as the tests do.  Asking for CUDA without
a GPU raises; nothing falls back silently.

The experiment directory (config, state, ``metrics.jsonl``, ``ckpt/``)
is created at the first write, so an engine that only takes steps writes
nothing.  A checkpoint holds the model's parameters and BatchNorm
statistics, the optimizer's moments and count, and the engine's generator,
so a restored engine draws what the uninterrupted one would.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..config import Experiment, TrainConfig
from ..nn import DeformableTetNetwork
from ..tetgrid import build_tet_grid, face_lattice_info
from ..utils.timing import TimingRegistry
from .checkpoint import restore_checkpoint, save_checkpoint
from .statics import build_grid_statics, lattice_offsets, lattice_tet_offsets
from .step import eval_step, forward_losses, make_optimizer, train_step


def _check_supported(config: TrainConfig) -> None:
    unsupported = {
        "use_disn": config.use_disn,
        "use_lap_layer": config.use_lap_layer,
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
                 experiment: Optional[Experiment] = None):
        _check_supported(config)
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
        grid = build_tet_grid(config.res)
        self.statics = build_grid_statics(config.res, grid=grid,
                                          device=self.device)
        self.lattice_offsets = lattice_offsets(grid)
        self.tet_lattice = lattice_tet_offsets(grid)
        self.face_lattice = face_lattice_info(grid)
        init_gen = torch.Generator().manual_seed(config.seed)
        self.model = DeformableTetNetwork(
            blocks=config.parsed_blocks(),
            use_two_encoder=config.use_two_encoder,
            scale_pos=config.scale_pos,
            scale_pvcnn=config.scale_pvcnn,
            train_def=config.train_def,
            gcn_hidden=config.parsed_gcn_hidden(),
            pos_mlp_hidden=config.parsed_pos_mlp_hidden(),
            occ_mlp_hidden=config.parsed_occ_mlp_hidden(),
            dtype=torch.bfloat16 if config.precision == "bf16" else None,
            generator=init_gen,
        ).to(self.device)
        if config.pretrain:
            # warm start from another experiment's best checkpoint:
            # parameters and BatchNorm statistics, a fresh optimizer
            tree = restore_checkpoint(os.path.join(config.pretrain, "ckpt"),
                                      "best", map_location="cpu")
            self.model.load_state_dict(tree["model"])
        self.optimizer = make_optimizer(config, list(self.model.parameters()))
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.seed + 1)
        self._infer_step = None  # built at the first inference validation
        self.timing = TimingRegistry(enabled=config.timing,
                                     device=self.device)
        self.global_step = 0
        self.best_iou = 0.0
        self.epoch = 0

    # ------------------------------------------------------------------ util
    @property
    def experiment(self) -> Experiment:
        if self._experiment is None:
            self._experiment = Experiment.new(self.config)
        return self._experiment

    def _log(self, record: Dict) -> None:
        with open(self.experiment.file_path("metrics.jsonl"), "a") as f:
            f.write(json.dumps(record) + "\n")

    def _prep_batch(self, batch: Dict[str, np.ndarray]):
        """Numeric batch entries as tensors on the engine's device."""
        out = {}
        for k, v in batch.items():
            if isinstance(v, torch.Tensor):
                out[k] = v.to(self.device)
            elif isinstance(v, np.ndarray) and (
                    np.issubdtype(v.dtype, np.number)
                    or np.issubdtype(v.dtype, np.bool_)):
                out[k] = torch.as_tensor(v, device=self.device)
        return out

    def _lattice(self):
        return dict(lattice_offsets=self.lattice_offsets,
                    tet_lattice=self.tet_lattice,
                    face_lattice=self.face_lattice)

    def _save_vis(self, batch, name: str) -> None:
        from ..evals.harness import save_predicted_surface_objs

        save_predicted_surface_objs(
            self.model, batch, self.statics, self.config,
            self.experiment.file_path(name), **self._lattice())

    # ----------------------------------------------------------------- train
    def train_step(self, batch, draws=None) -> Dict[str, torch.Tensor]:
        """One optimizer update on a prepared batch; returns the terms."""
        terms = train_step(self.model, self.optimizer, batch, self.statics,
                           self.config, self.generator, draws=draws,
                           **self._lattice())
        self.global_step += 1
        return terms

    def forward_losses(self, batch, train: bool = True, draws=None):
        """(total, terms) without an update (for gradients or parity)."""
        return forward_losses(self.model, batch, self.statics, self.config,
                              self.generator, train=train, draws=draws,
                              **self._lattice())

    def train_epoch(self, batches: Iterator[Dict[str, np.ndarray]]) -> Dict:
        """One epoch over numpy batches; returns the mean terms.  The sums
        stay on the device: the host reads them only where it logs."""
        dev_sums = None
        n = 0
        t0 = time.perf_counter()
        for batch in batches:
            prepped = self._prep_batch(batch)
            with self.timing.region("train_step"):
                terms = self.train_step(prepped)
            n += 1
            want_log = self.global_step % 10 == 0 or n == 1
            want_print = (self.config.print_every
                          and self.global_step % self.config.print_every == 0)
            if want_log or want_print:
                host = {k: float(v) for k, v in terms.items()}
                if want_log:
                    self._log({"kind": "train", "step": self.global_step,
                               **host})
                if want_print:
                    print(f"step {self.global_step} "
                          f"total={host.get('total', 0.0):.4f} "
                          f"occ={host.get('occ', 0.0):.4f} "
                          f"occ_iou={host.get('occ_iou', 0.0):.4f}",
                          flush=True)
            if (self.config.save_vis and self.config.save_vis_every
                    and self.global_step % self.config.save_vis_every == 0):
                self._save_vis(prepped, f"vis_{self.global_step}")
            dev_sums = (dict(terms) if dev_sums is None
                        else {k: dev_sums[k] + v for k, v in terms.items()})
        self.epoch += 1
        means = {k: float(v) / max(n, 1) for k, v in (dev_sums or {}).items()}
        means["steps_per_sec"] = n / max(time.perf_counter() - t0, 1e-9)
        return means

    # ------------------------------------------------------------------ eval
    def validate(self, batches: Iterator[Dict[str, np.ndarray]]) -> Dict:
        """Mean validation terms, ``occ_iou`` included.  With save_vis the
        first batch's predicted surfaces are written as OBJs."""
        sums: Dict[str, torch.Tensor] = {}
        n = 0
        for batch in batches:
            prepped = self._prep_batch(batch)
            if n == 0 and self.config.save_vis:
                self._save_vis(prepped, f"vis_{self.global_step}")
            terms = eval_step(self.model, prepped, self.statics, self.config,
                              self.generator, **self._lattice())
            for k, v in terms.items():
                sums[k] = sums[k] + v if k in sums else v
            n += 1
        if n == 0:
            raise ValueError(
                "validate() received no batches — check that the validation "
                "split has at least batch_size examples")
        means = {k: float(v) / n for k, v in sums.items()}
        self._log({"kind": "val", "step": self.global_step, **means})
        return means

    def inference_step(self):
        """The full-inference step of this engine's model (built once)."""
        if self._infer_step is None:
            from ..evals.harness import make_inference_step

            self._infer_step = make_inference_step(
                self.model, self.config, **self._lattice())
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
            terms = self.inference_step()(self._prep_batch(batch),
                                          self.statics, self.generator)
            for k, v in terms.items():
                sums[k] = sums[k] + v if k in sums else v
            n += 1
        if n == 0:
            return None
        means = {k: float(v) / n for k, v in sums.items()}
        self._log({"kind": "val_inference", "step": self.global_step,
                   **means})
        return means

    # ------------------------------------------------------------ checkpoint
    def save(self, best: bool = False) -> None:
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
        if self.timing.enabled:
            self.timing.save(self.experiment.file_path("timing.json"))

    def restore(self, name: str = "last") -> None:
        tree = restore_checkpoint(self.experiment.file_path("ckpt"), name,
                                  map_location="cpu")
        self.model.load_state_dict(tree["model"])
        self.optimizer.load_state_dict(tree["optimizer"])
        self.generator.set_state(tree["generator"])
        st = self.experiment.read_state()
        self.epoch = int(st.get("epoch", 0))
        self.best_iou = float(st.get("best_iou", 0.0))
        self.global_step = int(st.get("global_step", 0))

    # ------------------------------------------------------------------- fit
    def fit(self, train_iter_fn, val_iter_fn, epochs: Optional[int] = None):
        """Epochs of training, each validated every ``val_every`` epochs
        and checkpointed, ``best`` chosen by ``val_iou_max`` of the
        inference validation (``occ_iou`` without SDF samples)."""
        epochs = epochs if epochs is not None else self.config.epochs
        history = []
        for _ in range(epochs):
            train_means = self.train_epoch(train_iter_fn())
            record = {"epoch": self.epoch, "train": train_means}
            if self.epoch % self.config.val_every == 0:
                val_means = self.validate(val_iter_fn())
                record["val"] = val_means
                inf_means = (self.validate_inference(val_iter_fn())
                             if self.config.val_inference else None)
                if inf_means is not None:
                    record["val_inference"] = inf_means
                    val_iou = inf_means["val_iou_max"]
                else:
                    val_iou = val_means.get("occ_iou", 0.0)
                is_best = val_iou > self.best_iou
                if is_best:
                    self.best_iou = val_iou
                self.save(best=is_best)
            history.append(record)
        return history
