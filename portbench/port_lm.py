"""The port's language models as the LM drivers build them.

`build(cell, seed, device)` gives the program's `ModelConfig`, read from
the configuration file's `port`, and its weights, made from the run's
seed on the device (`weights.make` over the program's abstract tree).
A driver of another kind of system builds its own state and does not use
this module.

`model_config` fills every field of `ModelConfig` from the dict by the
field's type, so that every nested group the program has (`moe`, `mla`,
`ssm`, `rglru`, and any later one) and the `stacks` are built without a
list of them here.
"""
from __future__ import annotations

import dataclasses
import types
import typing

from portbench import weights


def _value(hint, value):
    """`value` from a configuration file, as the type `hint` wants it."""
    if value is None:
        return None
    if dataclasses.is_dataclass(hint):
        return from_dict(hint, value)
    origin, args = typing.get_origin(hint), typing.get_args(hint)
    if origin in (typing.Union, types.UnionType):
        inner = [a for a in args if a is not type(None)]
        return _value(inner[0], value) if len(inner) == 1 else value
    if origin is tuple:                     # tuple[X, ...]
        return tuple(_value(args[0], v) for v in value)
    return value


def from_dict(cls, data):
    """An instance of the dataclass `cls` from a JSON object (by field
    name) or a JSON list (the fields in order)."""
    hints = typing.get_type_hints(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    if isinstance(data, list):
        data = dict(zip(fields, data))
    unknown = set(data) - set(fields)
    if unknown:
        raise KeyError(f"{cls.__name__} has no field {sorted(unknown)}")
    return cls(**{k: _value(hints[k], v) for k, v in data.items()})


def model_config(port: dict):
    """The program's ModelConfig from a configuration file's `port`."""
    from repro_torch.models.config import ModelConfig

    return from_dict(ModelConfig, port)


def build(cell, seed: int, device):
    """(ModelConfig, the weights made from `seed` on `device`)."""
    from repro_torch.models import lm

    cfg = model_config(cell.config["port"])
    return cfg, weights.make(lm.init_abstract(cfg), cell.config["init"],
                             seed, device)
