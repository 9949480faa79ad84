"""Lagrangian particle tracking.

Reference: ``src/Models/LagrangianParticleTracking/`` (SURVEY.md §2.14) —
``LagrangianParticles`` (``LagrangianParticleTracking.jl:29-45``),
forward-Euler advection with velocity interpolation
(``lagrangian_particle_advection.jl``), wall/immersed ``restitution``
bounce-back, tracked-field interpolation
(``update_lagrangian_particle_properties.jl``).

Design: particles are a struct-of-arrays pytree ``(x, y, z,
properties...)``; advection is trilinear interpolation ``vmap``-ed over the
particle batch — one fused gather kernel per step, no per-particle loops.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from oceananigans_tpu.fields import LOC_C, LOC_U, LOC_V, LOC_W, interpolate
from oceananigans_tpu.grids.base import Flat, Periodic

__all__ = ["LagrangianParticles"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ParticleState:
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray
    properties: Dict[str, jnp.ndarray]


class LagrangianParticles:
    """A batch of particles advected by the model velocity field.

    ``tracked_fields`` maps property names to model field names; each
    property is updated by interpolation every step (reference
    ``update_lagrangian_particle_properties.jl``).
    """

    def __init__(self, x, y, z, restitution=1.0, tracked_fields=None):
        x = jnp.atleast_1d(jnp.asarray(x, jnp.result_type(float)))
        y = jnp.atleast_1d(jnp.asarray(y, x.dtype))
        z = jnp.atleast_1d(jnp.asarray(z, x.dtype))
        if not (x.shape == y.shape == z.shape):
            raise ValueError("x, y, z must have the same shape")
        self.restitution = float(restitution)
        self.tracked_fields = dict(tracked_fields or {})
        self.initial = ParticleState(
            x=x, y=y, z=z,
            properties={k: jnp.zeros_like(x) for k in self.tracked_fields})

    def __len__(self):
        return self.initial.x.shape[0]

    # ------------------------------------------------------------------
    def _bounds(self, grid, axis):
        name = "xyz"[axis]
        H, N = grid.H[axis], grid.N[axis]
        farr = np.asarray(getattr(grid, f"{name}F")).reshape(-1)
        return float(farr[H]), float(farr[H + N])

    def _enforce_boundaries(self, grid, q, axis):
        """Periodic wrap or restitution bounce (reference
        ``lagrangian_particle_advection.jl`` `enforce_boundary_conditions`).
        """
        topo = grid.axis_topo(axis)
        if topo == Flat:
            return q
        lo, hi = self._bounds(grid, axis)
        L = hi - lo
        if topo == Periodic:
            return lo + jnp.mod(q - lo, L)
        r = self.restitution
        # bounce: reflect about the wall, damped by restitution
        q = jnp.where(q > hi, hi - r * (q - hi), q)
        q = jnp.where(q < lo, lo + r * (lo - q), q)
        return jnp.clip(q, lo, hi)

    def advect(self, grid, particles: ParticleState, u, v, w, dt):
        """Forward-Euler advection (the reference's scheme,
        ``lagrangian_particle_advection.jl``)."""
        interp = jax.vmap(
            lambda fld, loc, xp, yp, zp: interpolate(grid, fld, loc, xp, yp,
                                                     zp),
            in_axes=(None, None, 0, 0, 0))
        up = interp(u, LOC_U, particles.x, particles.y, particles.z)
        vp = interp(v, LOC_V, particles.x, particles.y, particles.z)
        wp = interp(w, LOC_W, particles.x, particles.y, particles.z)
        x = self._enforce_boundaries(grid, particles.x + dt * up, 0)
        y = self._enforce_boundaries(grid, particles.y + dt * vp, 1)
        z = self._enforce_boundaries(grid, particles.z + dt * wp, 2)
        x, y, z = self._bounce_immersed(grid, particles, x, y, z)
        return dataclasses.replace(particles, x=x, y=y, z=z)

    def _bounce_immersed(self, grid, prev, x, y, z):
        """Particles landing in a solid immersed cell are bounced off the
        boundary with the restitution coefficient, by reflecting the
        overshoot back into the previous (wet) cell's bounds — the
        reference's ``bounce_immersed_particle``
        (``lagrangian_particle_advection.jl:50-101``)."""
        solid = getattr(grid, "solid_c", None)
        if solid is None:
            return x, y, z
        faces = []
        for name in "xyz":
            f = np.asarray(getattr(grid, f"{name}F")).reshape(-1)
            faces.append(jnp.asarray(f))

        def idx(f, q):
            return jnp.clip(jnp.searchsorted(f, q, side="right") - 1,
                            0, max(f.shape[0] - 2, 0))

        dest = solid[idx(faces[0], x), idx(faces[1], y), idx(faces[2], z)]
        r = self.restitution
        out = []
        for axis, (q, qp, f) in enumerate(
                ((x, prev.x, faces[0]), (y, prev.y, faces[1]),
                 (z, prev.z, faces[2]))):
            if grid.axis_topo(axis) == Flat or grid.N[axis] == 1:
                out.append(q)
                continue
            ip = idx(f, qp)
            lo, hi = f[ip], f[ip + 1]
            qb = jnp.where(q > hi, hi - r * (q - hi), q)
            qb = jnp.where(qb < lo, lo + r * (lo - qb), qb)
            qb = jnp.clip(qb, lo, hi)
            out.append(jnp.where(dest, qb, q))
        return tuple(out)

    def update_properties(self, grid, particles: ParticleState, fields):
        props = {}
        for prop, field_name in self.tracked_fields.items():
            fld = fields[field_name]
            interp = jax.vmap(
                lambda f_, xp, yp, zp: interpolate(grid, f_, LOC_C, xp, yp,
                                                   zp),
                in_axes=(None, 0, 0, 0))
            props[prop] = interp(fld, particles.x, particles.y, particles.z)
        return dataclasses.replace(particles, properties=props)

    def step(self, grid, particles, u, v, w, fields, dt):
        particles = self.advect(grid, particles, u, v, w, dt)
        if self.tracked_fields:
            particles = self.update_properties(grid, particles, fields)
        return particles
