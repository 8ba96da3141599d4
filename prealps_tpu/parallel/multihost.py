"""Multi-host initialization and mesh construction. EXPERIMENTAL: this
glue is untested across real hosts (the tests run two processes on one
machine); treat it as a starting point on a cluster.

The reference scales across nodes with plain `mpirun` — every rank is a
process and MPI wires them up (reference: README.md:53 `mpirun -np 8 ...`,
make.inc:25 mpicc). The JAX equivalent is `jax.distributed.initialize`: one
process per host, all devices of all hosts visible as one global device
list, collectives riding the intra-host interconnect within a host and the
network across hosts.

Mapping to the reference's two-level communicator split
(preAlps_utils.c:687 comm2LevelsSplit):

    masterLevel  <-> the cross-host ("host") mesh axis (network)
    localLevel   <-> the within-host ("chip") mesh axis (NVLink)

Usage on each host (driver scripts / cluster launchers):

    from prealps_tpu.parallel.multihost import initialize, global_mesh_2level
    initialize(coordinator="10.0.0.1:1234", num_processes=4, process_id=i)
    mesh = global_mesh_2level()          # (hosts, chips_per_host)
    solver = DistributedLorascECG.build(a, mesh_shape=mesh.devices.shape, ...)

Single-process runs (tests, one chip, CPU meshes) skip initialize() —
everything below degrades to the local device list.
"""

from __future__ import annotations

import numpy as np


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Wire this process into the JAX distributed runtime (idempotent).

    With no arguments, relies on the cluster environment
    (JAX_COORDINATOR_ADDRESS etc.); otherwise pass coordinator_address,
    num_processes and process_id.
    """
    import jax

    if getattr(jax.distributed, "is_initialized", None) and jax.distributed.is_initialized():
        return
    kwargs = {}
    if coordinator is not None:
        kwargs["coordinator_address"] = coordinator
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def global_mesh(axis: str = "shards"):
    """1-D mesh over every chip of every connected host."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis,))


def global_mesh_2level(axes: tuple = ("host", "chip")):
    """2-D (hosts × chips/host) mesh: outer axis across hosts, inner on-host.

    Collectives with axis_name=axes[1] stay on-host; axis_name=axes[0]
    crosses hosts — scope separator psums and other small reductions to
    the outer axis, bulk halo exchange to the inner one.
    """
    import jax
    from jax.sharding import Mesh

    devices = jax.devices()
    procs = max(
        (getattr(d, "process_index", 0) for d in devices), default=0
    ) + 1
    per = len(devices) // procs
    by_proc = sorted(devices, key=lambda d: (getattr(d, "process_index", 0), d.id))
    arr = np.array(by_proc).reshape(procs, per)
    return Mesh(arr, axes)


def make_global(mesh, pspec, host_array):
    """Host data (replicated per process) -> one GLOBAL sharded jax.Array.

    In multi-controller JAX every process holds only its own devices; a
    shard_map over the global mesh needs arrays whose sharding spans all
    processes. Each process calls this with the SAME host_array (matrix
    panels and rhs come from the same deterministic partition on every
    process — the reference ships panels over MPI instead,
    operator.c:82-121); jax materialises only the addressable shards
    locally and wires the rest into the global Array.
    """
    import jax
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, pspec)
    host_array = np.asarray(host_array)
    return jax.make_array_from_callback(
        host_array.shape, sharding, lambda idx: host_array[idx]
    )


def globalize_operands(mesh, specs: dict, operands: dict) -> dict:
    """Convert per-process host/local operand arrays into GLOBAL arrays
    matching their PartitionSpecs — a no-op in single-process runs.

    The distributed builders (parallel/lorasc_driver.py) construct operands
    as host numpy / process-local device arrays; a jitted shard_map over a
    multi-process mesh requires inputs whose sharding spans every process.
    Values that are already global (outputs of earlier global computations,
    e.g. the deflation lift) are passed through untouched. Every process
    must hold the SAME host values (the builders are deterministic
    straight-line SPMD code, the reference's every-rank-reads-the-operator
    discipline — operator.c:38)."""
    import jax

    if jax.process_count() == 1:
        return operands

    def _one(spec, v):
        if isinstance(v, jax.Array) and not v.is_fully_addressable:
            return v  # already spans the global mesh
        return make_global(mesh, spec, np.asarray(v))

    # specs values may be pytrees of PartitionSpecs mirroring operand
    # pytrees (e.g. the banded-factor bundle) — map leaf-wise
    return {
        k: jax.tree_util.tree_map(_one, specs[k], v)
        for k, v in operands.items()
    }


_REPLICATE_FNS: dict = {}


def replicate_to_host(mesh, x):
    """Fetch a (possibly cross-process row-sharded) global array to host
    numpy: replicate via one compiled all-gather, then read the local copy.
    Single-process arrays take the plain np.asarray path. The jitted
    gather is cached per mesh — a fresh lambda per call would re-trace on
    every solve round (refine loops call this up to 8x per solve)."""
    import jax

    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        fn = _REPLICATE_FNS.get(mesh)
        if fn is None:
            from jax.sharding import NamedSharding, PartitionSpec

            fn = jax.jit(
                lambda v: v,
                out_shardings=NamedSharding(mesh, PartitionSpec()),
            )
            _REPLICATE_FNS[mesh] = fn
        x = fn(x)
    return np.asarray(x)


def process_count() -> int:
    import jax

    return jax.process_count()


def is_coordinator() -> bool:
    import jax

    return jax.process_index() == 0
