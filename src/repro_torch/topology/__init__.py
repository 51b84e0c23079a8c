"""Decentralized topologies: network graphs, time-varying graph schedules,
masked neighbourhood aggregation, and the simulated server-free training
step with gradient or parameter gossip (port of ``repro/topology``)."""
from repro_torch.topology.graphs import (
    TOPOLOGY_NAMES,
    Topology,
    complete,
    erdos_renyi,
    get_topology,
    ring,
    star,
    torus2d,
)
from repro_torch.topology.masked import (
    MASKED_AGGREGATOR_NAMES,
    masked_aggregate,
    masked_aggregate_flat,
    masked_centered_clip,
    masked_geomed_blockwise,
    masked_geomed_groups,
    masked_krum,
    masked_mean,
    masked_median,
    masked_trimmed_mean,
    masked_weiszfeld,
    masked_weiszfeld_segments,
)
from repro_torch.topology.schedule import (
    SCHEDULE_NAMES,
    DeviceSchedule,
    GraphSchedule,
    as_schedule,
    erdos_renyi_schedule,
    get_schedule,
    validate_schedule,
)
from repro_torch.topology.schedule import cyclic as cyclic_schedule
from repro_torch.topology.schedule import static as static_schedule
from repro_torch.topology.decentralized_step import (
    GOSSIP_MODES,
    build_exchange,
    decentralized_aggregate,
    make_decentralized_step,
)
