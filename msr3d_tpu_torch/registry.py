"""String → class registries.

Copy of ``msr3d_tpu/registry.py`` for the port: the names the YAML configs
use (``MSR3D``, ``OSE3DSituation``, ``MSR3DMix``, ``MSQAScanNet``,
``LeoScanFamilyDatasetWrapper``, ``LeoTrainer``, ...) resolve through these
registries, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional, Tuple


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, Callable] = {}

    @property
    def name(self) -> str:
        return self._name

    def register(self, obj: Optional[Callable] = None, *, name: Optional[str] = None):
        """Use as ``@REG.register()`` or ``REG.register(cls)``."""
        if obj is None:

            def deco(fn_or_class: Callable) -> Callable:
                self._do_register(name or fn_or_class.__name__, fn_or_class)
                return fn_or_class

            return deco
        self._do_register(name or obj.__name__, obj)
        return obj

    def _do_register(self, name: str, obj: Callable) -> None:
        if name in self._obj_map and self._obj_map[name] is not obj:
            raise ValueError(f"{name!r} already registered in {self._name!r} registry")
        self._obj_map[name] = obj

    def get(self, name: str) -> Callable:
        if name not in self._obj_map:
            raise KeyError(
                f"{name!r} not found in {self._name!r} registry; "
                f"available: {sorted(self._obj_map)}"
            )
        return self._obj_map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map

    def __iter__(self) -> Iterator[Tuple[str, Callable]]:
        return iter(self._obj_map.items())

    def keys(self):
        return self._obj_map.keys()


VISION_REGISTRY = Registry("vision")
LANGUAGE_REGISTRY = Registry("language")
GROUNDING_REGISTRY = Registry("grounding")
HEADS_REGISTRY = Registry("heads")
MODEL_REGISTRY = Registry("model")
DATASET_REGISTRY = Registry("dataset")
DATASETWRAPPER_REGISTRY = Registry("dataset_wrapper")
EVALUATOR_REGISTRY = Registry("evaluator")
TRAINER_REGISTRY = Registry("trainer")
LOSS_REGISTRY = Registry("loss")

_MODULE_REGISTRIES = {
    "vision": VISION_REGISTRY,
    "language": LANGUAGE_REGISTRY,
    "grounding": GROUNDING_REGISTRY,
    "heads": HEADS_REGISTRY,
}


def build_module(module_type: str, cfg: Any, **kwargs: Any):
    """The registry of ``module_type`` → ``cfg.name``'s builder, called on ``cfg``."""
    registry = _MODULE_REGISTRIES[module_type]
    return registry.get(cfg.name)(cfg, **kwargs)
