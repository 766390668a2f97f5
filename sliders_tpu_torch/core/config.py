"""Training config: the reference's YAMLs, loaded with no pydantic or PyYAML
(port of sliders_tpu/core/config.py).

`RootConfig` and its sections are dataclasses with the JAX package's field
names, defaults and literal choices (themselves the reference's
`config_util.py:14-104` plus the `tpu:` section). `load_config_from_yaml`
reads the file with `core/yaml_subset.py` and builds the tree as pydantic
does in its lax mode: unknown keys are ignored, a section written with no
body (`train:`) takes its defaults, and values are coerced the way pydantic
coerces them (an int from an integral float or a numeric string, a float
from an int or a numeric string such as YAML's `1e-4`, a bool from 0/1 or
yes/no words); anything else raises a `ValueError` naming the field.

Of the `tpu:` section the port honours `remat`, `nan_check`,
`state_checkpoint_every`, `per_device_batch`, `attention` and, in the
text-slider loop, `profile_dir`; `donate` and `steps_per_call` are accepted
and have no effect (PyTorch frees buffers itself, and an eager step
dispatches once per iteration anyway). `dp` and `tp` size the process mesh
of the text, image and fleet CLIs (`parallel/mesh.py`), which build one, as
the JAX CLIs do, when there is more than one process or tp > 1; the FLUX
loop refuses `dp` or `tp` above 1 (ROADMAP queue 1, item 15).
"""

from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, field
from typing import Literal, Optional

from sliders_tpu_torch.core import yaml_subset

PRECISION_TYPES = Literal["fp32", "fp16", "bf16", "float32", "float16", "bfloat16"]
NETWORK_TYPES = Literal["lierla", "c3lier"]

TRAINING_METHODS = Literal[
    "noxattn",  # all layers except cross-attn and time_embed
    "innoxattn",  # all layers except cross-attn
    "selfattn",  # self-attn only
    "xattn",  # cross-attn only
    "full",  # everything
    "xattn-strict",  # cross-attn, excluding to_out
    "noxattn-hspace",  # noxattn filter, mid_block modules only
    "noxattn-hspace-last",  # noxattn filter, mid_block resnet-1 conv2 only
    "xattn-up",
    "xattn-down",
    "xattn-mid",
]

_BOOL_WORDS = {"0": False, "off": False, "f": False, "false": False, "n": False, "no": False,
               "1": True, "on": True, "t": True, "true": True, "y": True, "yes": True}


def _coerce(value, tp, where: str):
    """`value` as type `tp` under pydantic's lax rules, or ValueError."""
    origin = typing.get_origin(tp)
    if origin is typing.Union:  # Optional[X]
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        return None if value is None else _coerce(value, args[0], where)
    if origin is Literal:
        choices = typing.get_args(tp)
        if value in choices and isinstance(value, str):
            return value
        raise ValueError(f"{where}: input should be {' or '.join(repr(c) for c in choices)}, "
                         f"got {value!r}")
    if tp is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, (int, float)) and value in (0, 1):
            return bool(value)
        if isinstance(value, str) and value.lower() in _BOOL_WORDS:
            return _BOOL_WORDS[value.lower()]
        raise ValueError(f"{where}: input should be a valid boolean, got {value!r}")
    if tp is int:
        if isinstance(value, int):
            return int(value)
        if isinstance(value, float) and value.is_integer():
            return int(value)
        if isinstance(value, str):
            try:
                return int(value.strip())
            except ValueError:
                pass
        raise ValueError(f"{where}: input should be a valid integer, got {value!r}")
    if tp is float:
        if isinstance(value, (int, float)):
            return float(value)
        if isinstance(value, str):
            try:
                return float(value.strip())
            except ValueError:
                pass
        raise ValueError(f"{where}: input should be a valid number, got {value!r}")
    if tp is str:
        if isinstance(value, str):
            return value
        raise ValueError(f"{where}: input should be a valid string, got {value!r}")
    raise TypeError(f"{where}: unsupported field type {tp}")


def build(cls, values, where: str = ""):
    """A dataclass `cls` from a mapping, as pydantic builds a model: extra
    keys ignored, missing fields defaulted, values coerced, nested sections
    built recursively (a null section takes its defaults)."""
    where = where or cls.__name__
    if isinstance(values, cls):
        return values
    if not isinstance(values, dict):
        raise ValueError(f"{where}: input should be a mapping, got {values!r}")
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        name = f"{where}.{f.name}"
        tp = hints[f.name]
        if f.name not in values:
            if f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING:
                raise ValueError(f"{name}: field required")
            continue
        value = values[f.name]
        if dataclasses.is_dataclass(tp):
            if value is None and f.default_factory is not dataclasses.MISSING:
                continue  # a section written with no body takes its defaults
            kwargs[f.name] = build(tp, value, name)
        else:
            kwargs[f.name] = _coerce(value, tp, name)
    return cls(**kwargs)


def to_dict(obj) -> dict:
    """The dataclass tree as plain data (pydantic's `model_dump`)."""
    return dataclasses.asdict(obj)


@dataclass
class PretrainedModelConfig:
    name_or_path: str
    v2: bool = False
    v_pred: bool = False
    clip_skip: Optional[int] = None


@dataclass
class NetworkConfig:
    type: NETWORK_TYPES = "lierla"
    rank: int = 4
    alpha: float = 1.0
    training_method: TRAINING_METHODS = "full"


@dataclass
class TrainConfig:
    precision: PRECISION_TYPES = "bfloat16"
    noise_scheduler: Literal["ddim", "ddpm", "lms", "euler_a"] = "ddim"
    iterations: int = 500
    lr: float = 1e-4
    optimizer: str = "adamw"
    optimizer_args: str = ""
    lr_scheduler: str = "constant"
    max_denoising_steps: int = 50


@dataclass
class SaveConfig:
    name: str = "untitled"
    path: str = "./output"
    per_steps: int = 200
    precision: PRECISION_TYPES = "float32"
    # slider file format; the reference writes .pt by default
    # (train_lora.py:319) and also supports .safetensors (lora.py:245-248)
    format: Literal["safetensors", "pt"] = "safetensors"


@dataclass
class LoggingConfig:
    use_wandb: bool = False
    verbose: bool = False
    log_every: int = 10  # interval of the stdout metric lines


@dataclass
class OtherConfig:
    use_xformers: bool = False  # the reference's knob, kept for YAML compatibility


@dataclass
class TpuConfig:
    """The JAX package's device section (absent from the reference configs);
    see the module docstring for what the port honours."""

    dp: int = -1
    tp: int = 1
    attention: Literal["auto", "pallas", "xla"] = "auto"
    per_device_batch: int = 1
    remat: bool = True
    donate: bool = True
    profile_dir: str = ""
    nan_check: bool = False
    state_checkpoint_every: int = 0
    steps_per_call: int = 1


@dataclass
class RootConfig:
    prompts_file: str
    pretrained_model: PretrainedModelConfig
    network: NetworkConfig = field(default_factory=NetworkConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    save: SaveConfig = field(default_factory=SaveConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    other: OtherConfig = field(default_factory=OtherConfig)
    tpu: TpuConfig = field(default_factory=TpuConfig)

    @classmethod
    def from_dict(cls, values: dict) -> "RootConfig":
        return build(cls, values)


def load_config_from_yaml(config_path: str) -> RootConfig:
    """Reference `config_util.load_config_from_yaml` semantics: missing or
    empty sections take their defaults."""
    return RootConfig.from_dict(yaml_subset.load(config_path))
