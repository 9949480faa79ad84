"""Output writers and readers: HDF5 field output, checkpointing, time series.

Reference layer: ``src/OutputWriters/`` + ``src/OutputReaders/``
(SURVEY.md §2.16) — ``JLD2Writer`` (``jld2_writer.jl:12-24``; JLD2 is an
HDF5 container, so :class:`HDF5Writer` is the direct equivalent),
``Checkpointer`` (``checkpointer.jl:10-26``), ``WindowedTimeAverage``
(``windowed_time_average.jl:152``), ``FieldTimeSeries``
(``src/OutputReaders/field_time_series.jl:219``).

All IO is host-side between jitted windows; arrays cross the device
boundary once per scheduled output (optionally downcast to float32, the
reference's ``array_type=Array{Float32}`` convention).
"""

from __future__ import annotations

import glob
import os
import re
from typing import Optional

import jax.numpy as jnp
import numpy as np

from oceananigans_tpu.fields import interior
from oceananigans_tpu.utils.schedules import (
    AveragedTimeInterval, IterationInterval, TimeInterval,
)

__all__ = ["HDF5Writer", "JLD2Writer", "Checkpointer", "OrbaxCheckpointer",
           "FieldTimeSeries", "FileSizeLimit", "InMemory", "OnDisk",
           "load_field_time_series", "WindowedTimeAverage"]


def _h5py():
    """h5py, imported when a writer or reader first needs it, so that
    importing the package does not require it."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "HDF5 output and input need the h5py package, which is not "
            "installed") from e
    return h5py


def _fetch(model, state, output, with_halos=False):
    """Materialize one named output: a field name, or a callable
    ``f(model, state) -> array`` (reference fetch_output.jl).
    ``with_halos=True`` keeps the halo points of named fields
    (``jld2_writer.jl`` with_halos)."""
    if callable(output):
        return np.asarray(output(model, state))
    trim = (lambda a: a) if with_halos else (
        lambda a: interior(model.grid, a))
    fields = state.fields()
    if output in fields:
        return np.asarray(trim(fields[output]))
    if output == "pressure":
        return np.asarray(trim(state.pressure))
    raise KeyError(f"unknown output {output!r}")


def _output_location(model, output):
    """Staggered location of a named output ("fcc" style letters, one per
    axis — the reference's ``loc2letter``/``minimal_location_string``,
    ``ext/OceananigansNCDatasetsExt.jl:97-108``). Callable outputs and
    unknown names default to cell centers."""
    from oceananigans_tpu.grids.base import Center, Face
    if not isinstance(output, str):
        return "ccc"
    locs = getattr(model, "locations", None)
    loc = None
    if locs and output in locs:
        loc = locs[output]
    elif output in ("u", "uh"):
        loc = (Face, Center, Center)
    elif output in ("v", "vh"):
        loc = (Center, Face, Center)
    elif output == "w":
        loc = (Center, Center, Face)
    if loc is None:
        return "ccc"
    return "".join("f" if l == Face else "c" for l in loc)


class HDF5Writer:
    """Writes named outputs on a schedule into one HDF5 file, with the
    time axis unlimited — the JLD2Writer equivalent
    (``jld2_writer.jl:12-24``).

    Layout: ``/times`` (T,), ``/iterations`` (T,), ``/fields/<name>``
    (T, nx, ny, nz), ``/grid/{x,y,z}`` coordinate vectors.
    """

    def __init__(self, outputs, filename, schedule, array_type=np.float32,
                 overwrite_existing=True, with_halos=False,
                 file_splitting=None):
        self.outputs = outputs
        self.base_filename = str(filename)
        self.schedule = schedule
        self.array_type = array_type
        self.with_halos = with_halos
        #: ``FileSizeLimit(bytes)`` or any schedule (e.g. TimeInterval):
        #: when triggered, subsequent writes go to ``_part2``, ``_part3``…
        #: files (reference ``jld2_writer.jl`` file_splitting)
        self.file_splitting = file_splitting
        self.part = 1
        self.filename = self._part_filename()
        if overwrite_existing and os.path.exists(self.filename):
            os.remove(self.filename)
        os.makedirs(os.path.dirname(os.path.abspath(self.filename)),
                    exist_ok=True)
        self._initialized = False

    def _part_filename(self):
        if self.file_splitting is None or self.part == 1:
            return self.base_filename
        root, ext = os.path.splitext(self.base_filename)
        return f"{root}_part{self.part}{ext}"

    def _maybe_split(self, sim):
        fs = self.file_splitting
        if fs is None or not self._initialized:
            return
        if isinstance(fs, FileSizeLimit):
            split = (os.path.exists(self.filename)
                     and os.path.getsize(self.filename) >= fs.size_limit)
        else:   # any schedule object
            split = fs.actuates(sim.state.clock)
        if split:
            self.part += 1
            self.filename = self._part_filename()
            if os.path.exists(self.filename):
                os.remove(self.filename)
            self._initialized = False

    def _init_file(self, sim, shapes):
        from oceananigans_tpu.grids.base import Face
        with _h5py().File(self.filename, "a") as f:
            f.create_dataset("times", shape=(0,), maxshape=(None,),
                             dtype=np.float64)
            f.create_dataset("iterations", shape=(0,), maxshape=(None,),
                             dtype=np.int64)
            g = sim.model.grid
            grp = f.create_group("grid")
            grp.create_dataset("x", data=np.asarray(g.xnodes()).ravel())
            grp.create_dataset("y", data=np.asarray(g.ynodes()).ravel())
            grp.create_dataset("z", data=np.asarray(g.znodes()).ravel())
            # face coordinates for staggered fields (reference
            # loc2letter per-location dims, OceananigansNCDatasetsExt)
            try:
                grp.create_dataset(
                    "xF", data=np.asarray(g.xnodes(Face)).ravel())
                grp.create_dataset(
                    "yF", data=np.asarray(g.ynodes(Face)).ravel())
                grp.create_dataset(
                    "zF", data=np.asarray(g.znodes(Face)).ravel())
            except TypeError:
                pass    # curvilinear stacks expose centers only
            grp.attrs["Nx"], grp.attrs["Ny"], grp.attrs["Nz"] = g.N
            fg = f.create_group("fields")
            for name, shape in shapes.items():
                ds = fg.create_dataset(name, shape=(0, *shape),
                                       maxshape=(None, *shape),
                                       dtype=self.array_type,
                                       chunks=(1, *shape))
                ds.attrs["location"] = _output_location(
                    sim.model, self.outputs[name])
        self._initialized = True

    def write(self, sim):
        self._maybe_split(sim)
        data = {name: _fetch(sim.model, sim.state, out, self.with_halos)
                for name, out in self.outputs.items()}
        if not self._initialized:
            self._init_file(sim, {k: v.shape for k, v in data.items()})
        with _h5py().File(self.filename, "a") as f:
            n = f["times"].shape[0]
            f["times"].resize((n + 1,))
            f["times"][n] = float(sim.state.clock.time)
            f["iterations"].resize((n + 1,))
            f["iterations"][n] = int(sim.state.clock.iteration)
            for name, arr in data.items():
                ds = f["fields"][name]
                ds.resize((n + 1, *arr.shape))
                ds[n] = arr.astype(self.array_type)


#: alias matching the reference's name
JLD2Writer = HDF5Writer


class NetCDFWriter:
    """CF-style netCDF-4 output (reference ``netcdf_writer.jl:7`` +
    ``ext/OceananigansNCDatasetsExt.jl``).

    netCDF-4 is an HDF5 profile: this writer produces a file with proper
    dimension scales (time, x/y/z per staggering) attached to each
    variable plus CF attributes, readable by netCDF4/xarray/ncdump.
    """

    def __init__(self, outputs, filename, schedule, array_type=np.float32,
                 overwrite_existing=True, global_attributes=None):
        self.outputs = outputs
        self.filename = str(filename)
        self.schedule = schedule
        self.array_type = array_type
        self.global_attributes = dict(global_attributes or {})
        if overwrite_existing and os.path.exists(self.filename):
            os.remove(self.filename)
        os.makedirs(os.path.dirname(os.path.abspath(self.filename)),
                    exist_ok=True)
        self._initialized = False

    @staticmethod
    def _coordinate_schema(g):
        """CF coordinate schema per grid family, with BOTH staggerings of
        every spatial axis (reference ``ext/OceananigansNCDatasetsExt.jl``
        ``loc2letter``/``minimal_location_string`` per-location dims):

        - rectilinear: ``x``/``xF`` … metric coordinates;
        - LatitudeLongitude: ``longitude``/``longitude_f`` etc.;
        - orthogonal shells: index dims ``i``/``i_f``/``j``/``j_f`` +
          2-D geographic auxiliary coordinates at (c,c)/(f,c)/(c,f);
        - cubed sphere: leading ``panel`` dim + the same.

        Returns ``(panel_dim_or_None, axes, aux, coords)`` where ``axes``
        is a per-spatial-axis list of ``{"c": (name, vals, attrs),
        "f": (name, vals, attrs)}`` (face arrays are trimmed to N — the
        first face of each interior cell — matching the writers'
        interior views), ``aux`` the 2-D coordinate variables, and
        ``coords`` a dict mapping horizontal staggering ("cc"/"fc"/"cf")
        to the CF ``coordinates`` attribute value (or None).
        """
        from oceananigans_tpu.grids.base import Face
        from oceananigans_tpu.grids.cubed_sphere_grid import (
            ConformalCubedSphereGrid,
        )
        from oceananigans_tpu.grids.latlon import LatitudeLongitudeGrid
        from oceananigans_tpu.grids.orthogonal import (
            OrthogonalSphericalShellGrid,
        )
        from oceananigans_tpu.immersed import ImmersedBoundaryGrid
        if isinstance(g, ImmersedBoundaryGrid):
            g = g.underlying_grid
        deg_e = {"units": "degrees_east", "standard_name": "longitude"}
        deg_n = {"units": "degrees_north", "standard_name": "latitude"}
        zattrs = {"units": "m", "positive": "up",
                  "standard_name": "depth"}

        def zaxis():
            zc = np.asarray(g.znodes()).ravel()
            zf = np.asarray(g.znodes(Face)).ravel()[:len(zc)]
            return {"c": ("z", zc, zattrs), "f": ("zF", zf, zattrs)}

        if isinstance(g, ConformalCubedSphereGrid):
            N = g.N_panel
            panel = ("panel", np.arange(6), {"long_name": "cube panel"})
            axes = [
                {"c": ("i", np.arange(N),
                       {"long_name": "panel x index"}),
                 "f": ("i_f", np.arange(N),
                       {"long_name": "panel x face index"})},
                {"c": ("j", np.arange(N),
                       {"long_name": "panel y index"}),
                 "f": ("j_f", np.arange(N),
                       {"long_name": "panel y face index"})},
                zaxis(),
            ]

            # per-panel geographic coordinates at the three horizontal
            # staggerings (faces trimmed to the first N); shared helper
            # so writer coordinates are identical to the ones the model
            # evaluates forcings/BCs on
            from oceananigans_tpu.grids.cubed_sphere_grid import (
                panel_geographic_coords as geo,
            )
            d = 2.0 / N
            tC = -1.0 + d * (np.arange(N) + 0.5)
            tF = -1.0 + d * np.arange(N)
            lam_fc, phi_fc = geo(tF, tC)
            lam_cf, phi_cf = geo(tC, tF)
            aux = [("longitude", np.asarray(g.lam_cc), deg_e),
                   ("latitude", np.asarray(g.phi_cc), deg_n),
                   ("longitude_fc", lam_fc, deg_e),
                   ("latitude_fc", phi_fc, deg_n),
                   ("longitude_cf", lam_cf, deg_e),
                   ("latitude_cf", phi_cf, deg_n)]
            coords = {"cc": "longitude latitude",
                      "fc": "longitude_fc latitude_fc",
                      "cf": "longitude_cf latitude_cf"}
            return panel, axes, aux, coords
        if isinstance(g, OrthogonalSphericalShellGrid):
            sx, sy, _ = g.interior_slices
            axes = [
                {"c": ("i", np.arange(g.Nx),
                       {"long_name": "grid x index"}),
                 "f": ("i_f", np.arange(g.Nx),
                       {"long_name": "grid x face index"})},
                {"c": ("j", np.arange(g.Ny),
                       {"long_name": "grid y index"}),
                 "f": ("j_f", np.arange(g.Ny),
                       {"long_name": "grid y face index"})},
                zaxis(),
            ]
            aux = [("longitude", np.asarray(g.lamCC)[sx, sy, 0], deg_e),
                   ("latitude", np.asarray(g.phiCC)[sx, sy, 0], deg_n),
                   ("longitude_fc", np.asarray(g.lamFC)[sx, sy, 0],
                    deg_e),
                   ("latitude_fc", np.asarray(g.phiFC)[sx, sy, 0],
                    deg_n),
                   ("longitude_cf", np.asarray(g.lamCF)[sx, sy, 0],
                    deg_e),
                   ("latitude_cf", np.asarray(g.phiCF)[sx, sy, 0],
                    deg_n)]
            coords = {"cc": "longitude latitude",
                      "fc": "longitude_fc latitude_fc",
                      "cf": "longitude_cf latitude_cf"}
            return None, axes, aux, coords
        if isinstance(g, LatitudeLongitudeGrid):
            axes = [
                {"c": ("longitude", np.asarray(g.xnodes()).ravel(),
                       deg_e),
                 "f": ("longitude_f",
                       np.asarray(g.xnodes(Face)).ravel()[:g.N[0]],
                       deg_e)},
                {"c": ("latitude", np.asarray(g.ynodes()).ravel(),
                       deg_n),
                 "f": ("latitude_f",
                       np.asarray(g.ynodes(Face)).ravel()[:g.N[1]],
                       deg_n)},
                zaxis(),
            ]
            return None, axes, [], {}
        m = {"units": "m"}
        axes = [
            {"c": ("x", np.asarray(g.xnodes()).ravel(), m),
             "f": ("xF", np.asarray(g.xnodes(Face)).ravel()[:g.N[0]],
                   m)},
            {"c": ("y", np.asarray(g.ynodes()).ravel(), m),
             "f": ("yF", np.asarray(g.ynodes(Face)).ravel()[:g.N[1]],
                   m)},
            zaxis(),
        ]
        return None, axes, [], {}

    def _init_file(self, sim, shapes):
        g = sim.model.grid
        panel, axes, aux, coords = self._coordinate_schema(g)
        with _h5py().File(self.filename, "a") as f:
            for key, val in self.global_attributes.items():
                f.attrs[key] = val
            f.attrs["Conventions"] = "CF-1.8"
            f.attrs["source"] = "oceananigans_tpu"
            t = f.create_dataset("time", shape=(0,), maxshape=(None,),
                                 dtype=np.float64)
            t.attrs["units"] = "seconds"
            t.attrs["long_name"] = "model time"
            t.make_scale("time")

            def make_scale_ds(name, vals, attrs):
                d = f.create_dataset(name, data=vals)
                for k, v in attrs.items():
                    d.attrs[k] = v
                d.make_scale(name)
                return d

            if panel is not None:
                panel_ds = make_scale_ds(*panel)
            scale_ds = []      # per spatial axis: {"c": ds, "f": ds}
            for ax in axes:
                scale_ds.append({key: make_scale_ds(*ent)
                                 for key, ent in ax.items()})
            for name, vals, attrs in aux:
                d = f.create_dataset(name, data=vals)
                for k, v in attrs.items():
                    d.attrs[k] = v
            for name, shape in shapes.items():
                loc = _output_location(sim.model, self.outputs[name])
                ds = f.create_dataset(name, shape=(0, *shape),
                                      maxshape=(None, *shape),
                                      dtype=self.array_type,
                                      chunks=(1, *shape))
                ds.attrs["location"] = loc
                ds.dims[0].attach_scale(f["time"])
                off = 1 if panel is not None else 0
                # named prognostic fields are interior-shaped by
                # construction, so mismatches there are errors; CALLABLE
                # outputs may legitimately drop axes (1-D profiles, 2-D
                # means) — best-effort scale matching by length, like
                # the pre-round-4 behavior
                strict = isinstance(self.outputs[name], str)
                for di, n in enumerate(shape, start=1):
                    ax = di - 1
                    if panel is not None and ax == 0 and n == 6:
                        ds.dims[di].attach_scale(panel_ds)
                        continue
                    if panel is not None and ax == 0 and strict:
                        raise ValueError(
                            f"output {name!r}: leading axis has "
                            f"length {n}, expected 6 panels")
                    sp = ax - off
                    if sp >= 3 or sp < 0:
                        if strict:
                            raise ValueError(
                                f"output {name!r} has more than 3 "
                                f"spatial axes (shape {shape})")
                        continue
                    sds = scale_ds[sp][loc[sp]]
                    ln = sds.shape[0]
                    if n == 1 and ln != 1:
                        continue        # reduced axis (e.g. eta's z)
                    if ln != n:
                        if strict:
                            raise ValueError(
                                f"output {name!r} axis {sp} has length "
                                f"{n} but its {loc[sp]!r}-located "
                                f"coordinate {sds.name!r} has {ln}; "
                                f"writer outputs must be "
                                f"interior-shaped")
                        # callable: attach any center scale of matching
                        # length, else leave the axis unreferenced
                        for alt in scale_ds:
                            cand = alt.get("c")
                            if cand is not None and cand.shape[0] == n:
                                ds.dims[di].attach_scale(cand)
                                break
                        continue
                    ds.dims[di].attach_scale(sds)
                hloc = loc[:2]
                if coords.get(hloc):
                    ds.attrs["coordinates"] = coords[hloc]
                elif coords.get("cc"):
                    ds.attrs["coordinates"] = coords["cc"]
        self._initialized = True

    def write(self, sim):
        data = {name: _fetch(sim.model, sim.state, out)
                for name, out in self.outputs.items()}
        if not self._initialized:
            self._init_file(sim, {k: v.shape for k, v in data.items()})
        with _h5py().File(self.filename, "a") as f:
            n = f["time"].shape[0]
            f["time"].resize((n + 1,))
            f["time"][n] = float(sim.state.clock.time)
            for name, arr in data.items():
                ds = f[name]
                ds.resize((n + 1, *arr.shape))
                ds[n] = arr.astype(self.array_type)


class WindowedTimeAverage:
    """Wraps an output so a writer receives its trailing time average
    (reference ``windowed_time_average.jl:152``). Used with an
    ``AveragedTimeInterval`` schedule: the Simulation calls ``accumulate``
    every stride iterations inside the window (simplified: every write of
    the owning writer's sampling callback)."""

    def __init__(self, output):
        self.output = output
        self._sum = None
        self._n = 0

    def accumulate(self, model, state):
        v = _fetch(model, state, self.output)
        self._sum = v if self._sum is None else self._sum + v
        self._n += 1

    def __call__(self, model, state):
        if self._n == 0:
            self.accumulate(model, state)
        out = self._sum / self._n
        self._sum = None
        self._n = 0
        return out


class Checkpointer:
    """Serializes the full state pytree + clock so a run restarts with
    bitwise-identical AB2 tendency history (reference
    ``checkpointer.jl:10-26,220``)."""

    def __init__(self, dirname="checkpoints", schedule=None, prefix="ckpt",
                 cleanup=False, keep=2):
        self.dirname = str(dirname)
        self.schedule = schedule or IterationInterval(1000)
        self.prefix = prefix
        self.cleanup = cleanup
        self.keep = keep
        os.makedirs(self.dirname, exist_ok=True)

    def _path(self, iteration):
        return os.path.join(self.dirname,
                            f"{self.prefix}_iteration{iteration}.h5")

    def write(self, sim):
        import jax
        it = int(sim.state.clock.iteration)
        path = self._path(it)
        leaves, treedef = jax.tree_util.tree_flatten_with_path(sim.state)
        with _h5py().File(path, "w") as f:
            for keypath, leaf in leaves:
                key = jax.tree_util.keystr(keypath)
                f.create_dataset(key, data=np.asarray(leaf))
        if self.cleanup:
            ckpts = sorted(glob.glob(os.path.join(
                self.dirname, f"{self.prefix}_iteration*.h5")),
                key=_ckpt_iteration)
            for old in ckpts[:-self.keep]:
                os.remove(old)

    def restore(self, template_state, path=None):
        """Rebuild a state pytree from a checkpoint (reference
        ``set!(model, filepath)``). ``template_state`` provides structure
        and dtypes (e.g. ``model.initial_state()``)."""
        import jax
        if path is None:
            ckpts = sorted(glob.glob(os.path.join(
                self.dirname, f"{self.prefix}_iteration*.h5")),
                key=_ckpt_iteration)
            if not ckpts:
                raise FileNotFoundError(
                    f"no checkpoints under {self.dirname}")
            path = ckpts[-1]
        leaves, treedef = jax.tree_util.tree_flatten_with_path(
            template_state)
        with _h5py().File(path, "r") as f:
            new_leaves = []
            for keypath, leaf in leaves:
                key = jax.tree_util.keystr(keypath)
                data = np.asarray(f[key])
                new_leaves.append(jnp.asarray(data, leaf.dtype))
        return jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(template_state), new_leaves)


def _ckpt_iteration(path):
    m = re.search(r"iteration(\d+)", path)
    return int(m.group(1)) if m else -1


class OrbaxCheckpointer:
    """Distributed/sharded checkpointing via orbax (reference parity:
    ``checkpointer.jl`` for the capability; the implementation follows
    the jax ecosystem's native checkpoint layer so GSPMD-sharded states
    save each shard from its own host and restore with the template's
    shardings — the multi-host path HDF5 cannot provide)."""

    def __init__(self, dirname="checkpoints_orbax", schedule=None,
                 keep=2):
        import orbax.checkpoint as ocp
        self.dirname = os.path.abspath(str(dirname))
        self.schedule = schedule or IterationInterval(1000)
        self.keep = keep
        os.makedirs(self.dirname, exist_ok=True)
        self._ckpt = ocp.StandardCheckpointer()

    def _path(self, iteration):
        return os.path.join(self.dirname, f"iteration{iteration}")

    def write(self, sim):
        import jax
        state = sim.state if hasattr(sim, "state") else sim
        it = int(jax.device_get(state.clock.iteration))
        path = self._path(it)
        if os.path.exists(path):
            import shutil
            shutil.rmtree(path)
        self._ckpt.save(path, state)
        self._ckpt.wait_until_finished()
        ckpts = sorted(glob.glob(os.path.join(self.dirname, "iteration*")),
                       key=_ckpt_iteration)
        for old in ckpts[:-self.keep]:
            import shutil
            shutil.rmtree(old)

    def restore(self, template_state, path=None):
        """Restore into the structure/dtypes/SHARDINGS of
        ``template_state`` (e.g. a sharded ``initial_state``)."""
        import jax
        if path is None:
            ckpts = sorted(glob.glob(os.path.join(self.dirname,
                                                  "iteration*")),
                           key=_ckpt_iteration)
            if not ckpts:
                raise FileNotFoundError(
                    f"no checkpoints under {self.dirname}")
            path = ckpts[-1]
        abstract = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(
                jnp.shape(x), jnp.result_type(x),
                sharding=getattr(x, "sharding", None)),
            template_state)
        return self._ckpt.restore(path, abstract)


class FileSizeLimit:
    """File-splitting trigger by size in bytes (reference
    ``output_writer_utils.jl`` FileSizeLimit): pass as
    ``HDF5Writer(file_splitting=FileSizeLimit(200e6))``."""

    def __init__(self, size_limit):
        self.size_limit = int(size_limit)

    def __repr__(self):
        return f"FileSizeLimit({self.size_limit})"


class InMemory:
    """FieldTimeSeries backend keeping ``length`` snapshots in host
    memory as a moving window (reference ``field_time_series.jl:37-51``
    InMemory(length)); ``InMemory()`` holds the whole series."""

    def __init__(self, length=None):
        if length is not None and length < 2:
            raise ValueError("InMemory length must be >= 2")
        self.length = length


class OnDisk:
    """Lazy FieldTimeSeries backend: every index reads from the file
    (reference ``field_time_series.jl:63-70`` OnDisk)."""


class FieldTimeSeries:
    """4-D (time, x, y, z) series read from an HDF5Writer file, with
    linear time interpolation (reference ``field_time_series.jl:219``,
    ``field_time_series_indexing.jl``).

    ``backend``: ``InMemory()`` (default, all data in host memory),
    ``InMemory(n)`` (moving window of n snapshots — long series that
    don't fit in memory), or ``OnDisk()`` (every access reads the file).
    """

    def __init__(self, times, data, name="", filename=None,
                 backend=None):
        self.times = np.asarray(times)
        self.data = data                # None for OnDisk / windowed
        self.name = name
        self.filename = filename
        self.backend = backend or InMemory()
        self._window_start = 0
        self._window = None
        if isinstance(self.backend, InMemory) and \
                self.backend.length is not None and filename is None:
            raise ValueError("windowed InMemory backend needs filename=")
        if isinstance(self.backend, OnDisk) and filename is None:
            raise ValueError("OnDisk backend needs filename=")

    def __len__(self):
        return len(self.times)

    def _read(self, i):
        with _h5py().File(self.filename, "r") as f:
            return np.asarray(f["fields"][self.name][i])

    def __getitem__(self, i):
        if isinstance(self.backend, OnDisk):
            return self._read(i)
        if self.backend.length is None:
            return self.data[i]
        # moving window
        n = self.backend.length
        i = int(i)
        if self._window is None or not (
                self._window_start <= i < self._window_start + n):
            start = min(max(i, 0), max(len(self.times) - n, 0))
            with _h5py().File(self.filename, "r") as f:
                self._window = np.asarray(
                    f["fields"][self.name][start:start + n])
            self._window_start = start
        return self._window[i - self._window_start]

    def at_time(self, t):
        """Linear interpolation (clamped extrapolation) in time."""
        times = self.times
        t = float(t)
        if t <= times[0]:
            return self[0]
        if t >= times[-1]:
            return self[len(times) - 1]
        i = int(np.searchsorted(times, t) - 1)
        f = (t - times[i]) / (times[i + 1] - times[i])
        return (1 - f) * self[i] + f * self[i + 1]


def load_field_time_series(filename, name, backend=None):
    """Open a series written by HDF5Writer. ``backend``: ``InMemory()``
    (default), ``InMemory(n)``, or ``OnDisk()``. Multi-part files from
    ``file_splitting`` are NOT auto-concatenated; open each part."""
    backend = backend or InMemory()
    with _h5py().File(filename, "r") as f:
        times = np.asarray(f["times"])
        data = None
        if isinstance(backend, InMemory) and backend.length is None:
            data = np.asarray(f["fields"][name])
    return FieldTimeSeries(times, data, name, filename=filename,
                           backend=backend)


class FieldDataset:
    """All series in a writer's file, keyed by field name (reference
    ``src/OutputReaders/field_dataset.jl`` ``FieldDataset(filename)``).
    Lazily opens one :class:`FieldTimeSeries` per stored field."""

    def __init__(self, filename, backend=None):
        self.filename = filename
        self.backend = backend
        with _h5py().File(filename, "r") as f:
            self.names = tuple(f["fields"].keys())
        self._series = {}

    def __getitem__(self, name):
        if name not in self._series:
            if name not in self.names:
                raise KeyError(f"{name!r} not in {self.filename} "
                               f"(has {self.names})")
            self._series[name] = load_field_time_series(
                self.filename, name, backend=self.backend)
        return self._series[name]

    def keys(self):
        return self.names

    def __iter__(self):
        return iter(self.names)

    def __repr__(self):
        return f"FieldDataset({self.filename!r}, names={self.names})"
