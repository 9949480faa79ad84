"""oceananigans_tpu — a JAX/XLA ocean dynamical core.

A from-scratch reimplementation of the capabilities of Oceananigans.jl
(v0.96.19), in plain JAX that XLA compiles for the GPU and the CPU:

- a functional core: immutable ``Grid`` pytrees + ``State`` pytrees stepped by
  pure, jit-compiled functions (no mutable Field objects, no kernel launches);
- staggered Arakawa C-grid finite volume operators expressed as whole-array
  shifted ops that XLA fuses into a handful of HBM-bandwidth-bound kernels;
- FFT / Fourier-tridiagonal pressure Poisson solvers on top of XLA's FFT;
- multi-device scaling via ``jax.sharding.Mesh`` + ``shard_map`` halo
  exchange (neighbour collectives) rather than MPI.

Platform-dependent choices live in :mod:`oceananigans_tpu.platform`.
Layer order mirrors the reference's dependency order
(``src/Oceananigans.jl:209-251``) but the implementation is
idiomatic JAX throughout.
"""

from oceananigans_tpu.config import config, set_float_type, float_type
from oceananigans_tpu.grids import (
    Periodic, Bounded, Flat,
    Center, Face,
    RectilinearGrid,
    LatitudeLongitudeGrid,
    OrthogonalSphericalShellGrid,
    TripolarGrid,
    RotatedLatitudeLongitudeGrid,
    conformal_cubed_sphere_panel,
)
from oceananigans_tpu.immersed import (
    ImmersedBoundaryGrid, GridFittedBottom, GridFittedBoundary,
    PartialCellBottom, ImmersedBoundaryCondition,
)
from oceananigans_tpu.grids import (
    nodes, xnodes, ynodes, znodes, rnodes, lambda_nodes, phi_nodes,
    xspacings, yspacings, zspacings, rspacings,
    lambda_spacings, phi_spacings,
    minimum_xspacing, minimum_yspacing, minimum_zspacing,
)
from oceananigans_tpu.boundary_conditions import (
    BoundaryCondition,
    PeriodicBC, FluxBC, ValueBC, GradientBC, OpenBC,
    FluxBoundaryCondition, ValueBoundaryCondition,
    GradientBoundaryCondition, OpenBoundaryCondition,
    FlatExtrapolationOpenBC, PerturbationAdvection,
    PerturbationAdvectionOpenBC,
    FieldBoundaryConditions,
    fill_halo_regions,
)
from oceananigans_tpu.fields import (
    new_field, set_field,
    Field, CenterField, XFaceField, YFaceField, ZFaceField,
    BackgroundField,
    FunctionField, ConstantField, ZeroField, interior, with_interior,
    field_mean, field_max, field_min, field_abs_max, field_integral,
    interpolate,
    LOC_U, LOC_V, LOC_W, LOC_C,
)
from oceananigans_tpu.utils.units import (
    second, seconds, minute, minutes, hour, hours, day, days, year, years,
    meter, meters, kilometer, kilometers, KiB, MiB, GiB, TiB,
)
from oceananigans_tpu.advection import (
    Centered, UpwindBiased, WENO, FluxFormAdvection,
)
from oceananigans_tpu.coriolis import (
    FPlane, ConstantCartesianCoriolis, BetaPlane, NonTraditionalBetaPlane,
    HydrostaticSphericalCoriolis,
)
from oceananigans_tpu.buoyancy import (
    BuoyancyTracer, SeawaterBuoyancy, LinearEquationOfState, BuoyancyForce,
    TEOS10EquationOfState, TEOS10, BuoyancyField,
)
from oceananigans_tpu.stokes_drift import UniformStokesDrift, StokesDrift
from oceananigans_tpu.closures import (
    ScalarDiffusivity, VerticalScalarDiffusivity,
    HorizontalScalarDiffusivity, ScalarBiharmonicDiffusivity,
    VerticalScalarBiharmonicDiffusivity,
    HorizontalScalarBiharmonicDiffusivity,
    SmagorinskyLilly, DynamicSmagorinsky, Smagorinsky,
    LillyCoefficient, DynamicCoefficient,
    AnisotropicMinimumDissipation,
    ConvectiveAdjustmentVerticalDiffusivity,
    ExplicitTimeDiscretization, VerticallyImplicitTimeDiscretization,
    viscosity, diffusivity,
)
from oceananigans_tpu.closures_ocean import (
    CATKEVerticalDiffusivity, RiBasedVerticalDiffusivity,
    TKEDissipationVerticalDiffusivity, IsopycnalSkewSymmetricDiffusivity,
    LeithEnstrophyDiffusivity,
)
from oceananigans_tpu.forcings import (
    AdvectiveForcing, Forcing, Relaxation, GaussianMask, LinearTarget,
    MultipleForcings,
)
from oceananigans_tpu.particles import LagrangianParticles
from oceananigans_tpu.timesteppers import Clock
from oceananigans_tpu.models import (
    NonhydrostaticModel, HydrostaticFreeSurfaceModel, ShallowWaterModel,
    ConservativeFormulation, VectorInvariantFormulation,
    ExplicitFreeSurface, ImplicitFreeSurface, SplitExplicitFreeSurface,
    VectorInvariant, WENOVectorInvariant,
    OnlySelfUpwinding, CrossAndSelfUpwinding,
    PrescribedVelocityFields, ZCoordinate, ZStar,
    PressureField,
)
from oceananigans_tpu.simulation import (
    Callback, Simulation, TendencyCallsite, TimeStepCallsite,
    TimeStepWizard, UpdateStateCallsite, add_callback,
    conjure_time_step_wizard, iteration,
)
from oceananigans_tpu.utils.schedules import (
    TimeInterval, IterationInterval, WallTimeInterval, SpecifiedTimes,
    AveragedTimeInterval, AndSchedule, OrSchedule,
)
from oceananigans_tpu.diagnostics import (
    CFL, AdvectiveCFL, DiffusiveCFL, seawater_density,
)
from oceananigans_tpu.operations import (
    Average, Integral, CumulativeIntegral, ConditionalAverage,
    Reduction, Accumulation, KernelFunctionOperation,
)
from oceananigans_tpu.output import (
    HDF5Writer, JLD2Writer, NetCDFWriter, Checkpointer, FieldTimeSeries,
    FieldDataset, FileSizeLimit, InMemory, OnDisk, load_field_time_series,
)
from oceananigans_tpu.parallel import Distributed, Partition
from oceananigans_tpu.utils.pretty import prettytime

__version__ = "0.1.0"
