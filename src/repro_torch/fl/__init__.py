"""Federated engine of the port: stages, schedulers, scenarios."""
from repro_torch.comms.channel import ChannelConfig
from repro_torch.fl.async_buffer import AsyncConfig
from repro_torch.fl.engine import (EngineConfig, FederatedEngine, RoundRecord,
                                   RunResult, run_simulation)
from repro_torch.fl.sampling import SamplingConfig
from repro_torch.fl.scenarios import (SCENARIOS, Scenario, build_engine,
                                      build_protocol, default_setting,
                                      get_scenario, run_scenario)
from repro_torch.fl.server_opt import ServerOptConfig

__all__ = ["AsyncConfig", "ChannelConfig", "EngineConfig", "FederatedEngine",
           "RoundRecord", "RunResult", "SCENARIOS", "SamplingConfig",
           "Scenario", "ServerOptConfig", "build_engine", "build_protocol",
           "default_setting", "get_scenario", "run_scenario",
           "run_simulation"]
