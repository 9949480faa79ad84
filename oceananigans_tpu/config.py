"""Global configuration.

The reference keeps a single mutable default float type
(``src/Oceananigans.jl:152-157``); everything else is constructor keyword
arguments. We mirror that: one small mutable config object consulted at
*construction* time only — nothing inside a jitted step reads it, so changing
it never invalidates compiled code.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp


@dataclasses.dataclass
class Config:
    #: default floating point dtype for new grids/fields. float32 is the
    #: accelerator default; tests enable float64 (with jax_enable_x64) when
    #: validating against the Float64 reference.
    float_type: str = "float32"

    #: default halo width. 3 supports up to WENO-5 / Centered-6; grid
    #: constructors inflate it for higher-order schemes.
    halo: int = 3

    @property
    def float_dtype(self):
        return jnp.dtype(self.float_type)


config = Config()


def set_float_type(ft) -> None:
    config.float_type = jnp.dtype(ft).name


def float_type():
    return config.float_dtype
