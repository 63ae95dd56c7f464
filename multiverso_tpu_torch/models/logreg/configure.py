"""LogisticRegression configuration.

The port's copy of ``multiverso_tpu/models/logreg/configure.py``: a
key=value config-file parser with the keys and defaults of the reference
(Applications/LogisticRegression/src/configure.h:19-97, configure.cpp), so
reference config files (e.g. example/mnist.config) work unchanged. Lines
starting with '#' are comments; unknown keys warn.

One key is the port's own: ``platform`` (``cuda``, ``cuda:N`` or ``cpu``),
the device a local model trains on and a PS world starts on when the app
starts it. The app runs on the card unless the CPU is asked for.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

from multiverso_tpu_torch.utils.log import Log


@dataclass
class Configure:
    # dimensions (reference configure.h:20-22)
    input_size: int = 0
    output_size: int = 0
    # is input data sparse (configure.h:25)
    sparse: bool = False
    # training (configure.h:27-34)
    train_epoch: int = 1
    minibatch_size: int = 20
    read_buffer_size: int = 2048
    show_time_per_sample: int = 10000
    # objective/regular coefficients (configure.h:36-43)
    regular_coef: float = 0.0005
    learning_rate: float = 0.8
    learning_rate_coef: float = 1e6
    # FTRL parameters (configure.h:45-49)
    alpha: float = 0.005
    beta: float = 1.0
    lambda1: float = 5.0
    lambda2: float = 0.002
    # files (configure.h:51-77)
    init_model_file: str = ""
    train_file: str = "train.data"
    reader_type: str = "default"   # default / weight / bsparse
    test_file: str = ""
    output_model_file: str = "logreg.model"
    output_file: str = "logreg.output"
    # distributed mode (configure.h:79-87)
    use_ps: bool = False
    pipeline: bool = True
    sync_frequency: int = 1
    # algorithm selection (configure.h:89-97)
    updater_type: str = "default"    # default / sgd / ftrl
    objective_type: str = "default"  # default / sigmoid / softmax / ftrl
    regular_type: str = "default"    # default / L1 / L2
    # extension (no reference counterpart): the dtype the dense
    # objective's matmul inputs are rounded to. "bfloat16" halves the
    # staged samples' bytes; weights, gradients, and the loss stay float32
    # (mixed precision), so training trajectories track the float32 ones
    # to bf16 rounding.
    compute_type: str = "float32"    # float32 / bfloat16
    # extension 2: wire compression of the sparse PS table's row pushes
    # ("sparse": exact (index, value) pairs; "1bit": sign bits + per-row
    # error feedback; tables/base.py TableOption.compress). "" = off.
    compress: str = ""
    # extension 3: train whole windows on the device, on the PS tables'
    # device storage directly (models/logreg/device_plane.py). Requires
    # use_ps; dense, sparse and FTRL objectives.
    device_plane: bool = False
    # extension 4: parse-once epoch cache (data.py WindowCache)
    # — epoch 2+ replay the identical window sequence from memory instead
    # of re-parsing the text files; capped at cache_data_mb (larger
    # datasets stream every epoch, reference-style).
    cache_data: bool = True
    cache_data_mb: int = 4096
    # the port's device rule: cuda (the card) unless cpu is asked for
    platform: str = "cuda"

    @classmethod
    def from_file(cls, config_file: str) -> "Configure":
        cfg = cls()
        cfg.load(config_file)
        return cfg

    def load(self, config_file: str) -> None:
        typed = {f.name: f.type for f in fields(self)}
        with open(config_file) as f:
            for raw in f:
                line = raw.strip()
                if not line or line.startswith("#"):
                    continue
                key, _, val = line.partition("=")
                key, val = key.strip(), val.strip()
                if key not in typed:
                    Log.Error("[logreg] unknown config key %r", key)
                    continue
                current = getattr(self, key)
                if isinstance(current, bool):
                    setattr(self, key, val.lower() in ("true", "1", "yes"))
                elif isinstance(current, int):
                    setattr(self, key, int(float(val)))
                elif isinstance(current, float):
                    setattr(self, key, float(val))
                else:
                    setattr(self, key, val)
        self.finalize()

    def finalize(self) -> None:
        """Normalize derived settings; idempotent. Called from_file and by
        LogReg for programmatically-built configs."""
        if self.objective_type == "ftrl":
            # ftrl objective implies ftrl updater + sparse model
            # (reference updater.cpp:106-108, ftrl uses sparse entries)
            self.updater_type = "ftrl"
            self.sparse = True
        if self.compute_type not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_type={self.compute_type!r}: must be 'float32' or "
                "'bfloat16'")
