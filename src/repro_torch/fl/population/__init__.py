"""Population-scale client simulation (port of ``repro.fl.population``).

Three pieces let the engine run 10^5 to 10^6-client populations with
O(cohort) memory:

* client-state **stores** (:mod:`.store`): where per-client residuals and
  optimizer states live, on the device in memory or sharded and lazy on
  the host with LRU spill-to-disk;
* **virtual data views** (:mod:`.virtual`): virtual client ids hashed
  onto the base data shards, so a cohort's data gathers without the
  population ever existing;
* **traffic models** (:mod:`.traffic`): diurnal availability with
  timezone spread, device-class latency mixes and mid-round churn, feeding
  the schedulers' simulated clock.

Cohort selection over the virtual population is
:func:`repro_torch.fl.sampling.stream_cohort`; the per-client randomness
the three share is :mod:`repro_torch.core.prand`, the reference's draws
bit for bit.
"""
from repro_torch.fl.population.store import (ClientStateStore, InMemoryStore,
                                             ShardedLazyStore, StoreConfig,
                                             STORES, make_store)
from repro_torch.fl.population.traffic import (DEVICE_MIX_DEFAULT,
                                               DIURNAL_DEFAULT, DeviceClass,
                                               TRAFFIC_PRESETS, TrafficConfig,
                                               TrafficModel)
from repro_torch.fl.population.virtual import (SplitsView,
                                               VirtualPopulationView,
                                               make_view)

__all__ = [
    "ClientStateStore", "InMemoryStore", "ShardedLazyStore", "StoreConfig",
    "STORES", "make_store",
    "DeviceClass", "DEVICE_MIX_DEFAULT", "DIURNAL_DEFAULT",
    "TRAFFIC_PRESETS", "TrafficConfig", "TrafficModel",
    "SplitsView", "VirtualPopulationView", "make_view",
]
