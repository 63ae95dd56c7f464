"""LogReg: the config-file-driven train/test loop.

Counterpart of ``multiverso_tpu/models/logreg/logreg.py`` (reference
Applications/LogisticRegression/src/logreg.cpp), single-process: ``Train``
streams windows from the async reader through the model (logreg.cpp:40-87,
with per-``show_time_per_sample`` throughput lines), ``Test`` scores the
test file and writes predictions (logreg.cpp:121-172), ``SaveModel``
persists the weights.

In PS mode ``LogReg`` joins a started world or starts one on
``config.platform`` (the card unless the CPU is asked for) and closes what
it started. Device-plane window losses stay device scalars until the epoch
line. ``epoch_log`` keeps (samples, average loss, seconds) per epoch of
the last ``Train``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np

from multiverso_tpu_torch.models.logreg.configure import Configure
from multiverso_tpu_torch.models.logreg.data import (WindowCache,
                                                     WindowReader,
                                                     batch_samples,
                                                     iter_samples)
from multiverso_tpu_torch.models.logreg.model import Model
from multiverso_tpu_torch.utils.log import Log
from multiverso_tpu_torch.utils.timer import Timer
from multiverso_tpu_torch.utils.world import WorldOwner


class LogReg:
    def __init__(self, config: Union[str, Configure]):
        if isinstance(config, str):
            config = Configure.from_file(config)
        config.finalize()
        self.config = config
        self.epoch_log: List[Tuple[int, float, float]] = []
        self._world = WorldOwner()
        if config.use_ps:
            self._world.init_if_needed([f"-mv_device={config.platform}"])
        # model/table construction after MV_Init must not strand a
        # started world
        with self._world.guard("logreg.init"):
            self._world.require_single_process("LogisticRegression")
            self.model = Model.Get(config)
            # per-worker output files in PS mode (reference
            # ps_model.cpp:43-46 appends -<worker_id>); the caller's
            # Configure is never mutated
            self.output_model_file = config.output_model_file
            self.output_file = config.output_file
            if config.use_ps:
                from multiverso_tpu_torch import api
                wid = api.MV_WorkerId()
                if self.output_model_file:
                    self.output_model_file += f"-{wid}"
                if self.output_file:
                    self.output_file += f"-{wid}"
            if config.init_model_file and not config.use_ps:
                self.model.Load(config.init_model_file)

    def Train(self, train_file: Optional[str] = None) -> float:
        """One full training run (config.train_epoch epochs); returns the
        final epoch's average train loss per sample."""
        with self._world.guard("logreg.Train"):
            return self._train(train_file)

    def _train(self, train_file: Optional[str] = None) -> float:
        cfg = self.config
        files = train_file or cfg.train_file
        avg_loss = 0.0
        cache = WindowCache(cfg.cache_data_mb) if cfg.cache_data else None
        self.epoch_log = []
        for epoch in range(cfg.train_epoch):
            reader = (cache.reader(files, cfg, cfg.sync_frequency)
                      if cache is not None
                      else WindowReader(files, cfg, cfg.sync_frequency))
            timer = Timer()
            samples = 0
            loss_sum = 0.0
            next_report = cfg.show_time_per_sample
            while True:
                window = reader.next_window()
                if window is None:
                    break
                # a device scalar on the device plane: summed on the device
                loss_sum += self.model.train_window(window)
                samples += sum(b.count for b in window.batches)
                if samples >= next_report:
                    Log.Info("[logreg] epoch %d: %d samples, "
                             "%.1f samples/s, avg loss %.5f", epoch, samples,
                             samples / max(timer.elapse(), 1e-9),
                             float(loss_sum) / max(samples, 1))
                    next_report += cfg.show_time_per_sample
                    self.model.DisplayTime()
            # the epoch line: the one fetch of the device loss, which
            # waits for the epoch's device work
            avg_loss = float(loss_sum) / max(samples, 1)
            secs = timer.elapse()
            self.epoch_log.append((samples, avg_loss, secs))
            Log.Info("[logreg] epoch %d done: %d samples, avg loss %.5f, "
                     "%.2fs", epoch, samples, avg_loss, secs)
        if cfg.use_ps:
            from multiverso_tpu_torch import api
            api.MV_Barrier()
        if self.output_model_file:
            self.SaveModel()
        return avg_loss

    def Test(self, test_file: Optional[str] = None) -> float:
        """Score the test set; writes per-sample predictions to the output
        file; returns accuracy (reference logreg.cpp:121-172 counts correct
        predictions)."""
        files = test_file or self.config.test_file
        if not files:
            Log.Info("[logreg] no test file; skip test")
            return 0.0
        with self._world.guard("logreg.Test"):
            return self._test(files)

    def _test(self, files) -> float:
        cfg = self.config
        correct = total = 0
        out_lines: List[str] = []
        pending = []
        W = self.model.weights()  # one pull for the whole test pass
        for sample in iter_samples(files, cfg):
            pending.append(sample)
            if len(pending) == cfg.minibatch_size:
                c, t = self._score(pending, out_lines, W)
                correct, total = correct + c, total + t
                pending = []
        if pending:
            c, t = self._score(pending, out_lines, W)
            correct, total = correct + c, total + t
        if self.output_file:
            with open(self.output_file, "w") as f:
                f.write("\n".join(out_lines) + "\n")
        acc = correct / max(total, 1)
        Log.Info("[logreg] test: %d/%d correct (%.4f)", correct, total, acc)
        return acc

    def _score(self, pending, out_lines, W=None):
        cfg = self.config
        batch = batch_samples(pending, cfg, cfg.minibatch_size)
        preds = self.model.predict_batch(batch, W)
        labels = batch.labels[: batch.count]
        if cfg.output_size > 1:
            hard = np.argmax(preds, axis=1)
        else:
            hard = (preds[:, 0] >= 0.5).astype(np.int32)
        for p, h in zip(preds, hard):
            out_lines.append(" ".join(f"{x:.6f}" for x in np.atleast_1d(p))
                             + f" -> {h}")
        return int(np.sum(hard == labels)), int(batch.count)

    def SaveModel(self, path: Optional[str] = None) -> None:
        self.model.Store(path or self.output_model_file)

    def close(self) -> None:
        self._world.close()
