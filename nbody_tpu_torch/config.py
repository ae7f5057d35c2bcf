"""One experiment configuration tree with dotted-path CLI overrides — the
port of ``nbody_tpu/config.py``. The JSON files under ``configs/`` drive
both packages:

    python -m nbody_tpu_torch.experiments.run --config configs/contconv_adopted.json \
        --set train.epochs=20 --set model.kwargs.conv_impl=kernel

The JAX package's implementation names are mapped to the port's where a
model or a scene takes them: ``"xla"`` is ``"dense"`` and ``"pallas"`` (or
``"pallas_interpret"``) is ``"kernel"``, for ``conv_impl``, ``knn_impl``,
``radius_impl`` and the datagen ``force_backend``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

from nbody_tpu_torch.data.generate import ScenarioConfig

# JAX implementation name -> the port's
IMPL_NAMES = {"xla": "dense", "pallas": "kernel", "pallas_interpret": "kernel"}
_IMPL_KWARGS = ("conv_impl", "knn_impl", "radius_impl")
# a Morton neighbour search whose impl is unset follows the device
_MORTON_IMPLS = {"knn_method": "knn_impl", "radius_method": "radius_impl"}


def port_impl(name):
    """The port's name for a JAX implementation name (others unchanged)."""
    return IMPL_NAMES.get(name, name)


@dataclasses.dataclass
class DatagenConfig:
    """Fan-out datagen parameters; list-valued fields take the cartesian
    product. ``bh_near`` and ``bh_refresh`` are the treecode backends'
    (``force_backend`` "bh", "bh2", "bh3") near-set size and partition
    refresh interval."""

    n_bodies: Any = dataclasses.field(default_factory=lambda: [3, 25, 50, 100, 250, 500])
    integrator: str = "leapfrog"
    sim_type: Any = "spiral"
    steps: int = 1000
    dt: float = 1e-4
    softening: float = 0.05
    g: float = 4.5e-6
    total_mass: float = 1.0
    radial_scale: float = 3.0
    height_scale: float = 0.3
    black_hole_mass: float = 0.01
    n_arms: int = 2
    pitch_angle: float = -0.5235987755982988
    arm_strength: float = 0.3
    train_files: int = 10
    test_files: int = 1
    seed: Optional[int] = None
    force_backend: str = "auto"  # "auto" | "dense" | "kernel" (JAX "pallas") | "bh*"
    bh_near: int = 32
    bh_refresh: int = 1


@dataclasses.dataclass
class ModelConfig:
    """``type`` picks the surrogate family; ``kwargs`` feed its constructor."""

    type: str = "gnn"  # "gnn" | "contconv"
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 100
    batch_size: int = 64
    learning_rate: float = 0.01
    save_every: int = 10
    dt: float = 1e-4
    sim_steps: int = 1000
    scheduler_factor: float = 0.1
    scheduler_patience: int = 10
    seed: int = 0
    merge_files: bool = False
    batch_mode: str = "bucketed"  # "bucketed" | "mixed" | "reference"


@dataclasses.dataclass
class ExperimentConfig:
    name: str = "gnn"
    base: str = "."
    datagen: DatagenConfig = dataclasses.field(default_factory=DatagenConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentConfig":
        return cls(
            name=d.get("name", "gnn"),
            base=d.get("base", "."),
            datagen=DatagenConfig(**d.get("datagen", {})),
            model=ModelConfig(**d.get("model", {})),
            train=TrainConfig(**d.get("train", {})),
        )

    @classmethod
    def load(cls, path: str) -> "ExperimentConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    def apply_overrides(self, overrides: List[str]) -> "ExperimentConfig":
        """Apply ``a.b.c=value`` overrides (values parsed as JSON, falling
        back to raw strings)."""
        d = self.to_dict()
        for ov in overrides:
            key, sep, raw = ov.partition("=")
            if not sep:
                raise ValueError(f"override {ov!r} must look like path=value")
            try:
                value = json.loads(raw)
            except json.JSONDecodeError:
                value = raw
            node = d
            parts = key.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = value
        return ExperimentConfig.from_dict(d)

    def model_kwargs(self, device=None) -> dict:
        """``model.kwargs`` with sequences as tuples and the JAX
        implementation names mapped to the port's. With ``device`` (the
        resolved ``torch.device`` the model will run on), a Morton
        ``knn_method`` / ``radius_method`` whose impl is unset gets it here,
        once: ``"kernel"`` on cuda, ``"dense"`` elsewhere
        (``train.graphs.build_graph`` itself defaults to ``"dense"``)."""
        kw = {k: tuple(v) if isinstance(v, list) else v for k, v in self.model.kwargs.items()}
        for k in _IMPL_KWARGS:
            if k in kw:
                kw[k] = port_impl(kw[k])
        if device is not None:
            for method, impl in _MORTON_IMPLS.items():
                if kw.get(method) == "morton" and not kw.get(impl):
                    kw[impl] = "kernel" if device.type == "cuda" else "dense"
        return kw

    def build_model(self, generator=None, device=None):
        """The port's surrogate of ``model.type`` from ``model.kwargs``;
        ``generator`` draws its initial weights, ``device`` resolves an
        unset Morton search impl (:meth:`model_kwargs`). The model is built
        on the CPU: the caller moves it."""
        from nbody_tpu_torch.models import ContinuousConvModel, GraphModel

        models = {"gnn": GraphModel, "contconv": ContinuousConvModel}
        if self.model.type not in models:
            raise ValueError(f"unknown model type {self.model.type!r}")
        return models[self.model.type](**self.model_kwargs(device), generator=generator)

    def scenarios(self, seed: Optional[int] = None) -> List[ScenarioConfig]:
        from nbody_tpu_torch.data.generate import scenario_product

        d = dataclasses.asdict(self.datagen)
        for k in ("train_files", "test_files"):
            d.pop(k)
        d["force_backend"] = port_impl(d["force_backend"])
        if seed is not None:
            d["seed"] = seed
        return scenario_product(**d)
