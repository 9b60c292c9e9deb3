"""StashCache — the paper's contribution as a composable library.

The port of the reference's ``repro.core``: a distributed caching
federation of data origins, redirectors, caches and clients (paper §3),
plus the site-HTTP-proxy baseline it is evaluated against (§4.1), the
monitoring pipeline (§3.2), write-back caching (§6 future work) and a
fluid-flow discrete-event simulator for contended-network evaluation,
whose vector max-min solver runs as PyTorch tensor ops on the card.
The federation is accessed through one typed data plane
(``repro_torch.core.api``): ``DataPlane`` with ``AnalyticPlane`` /
``SimulatedPlane`` engines and declarative ``ScenarioSpec`` +
``run_scenario``.  Not ported yet: the batched sweeps (``SweepSpec``,
``run_sweep``) and the capacity planner.
"""
from .api import (AnalyticPlane, ClientPlane, DataPlane, FetchRequest,
                  FetchResult, ScenarioReport, ScenarioSpec, SimulatedPlane,
                  StatResult, WorkloadSpec, run_scenario)
from .cache import CacheServer, CacheStats
from .chunk import (DEFAULT_CHUNK_SIZE, ChunkRef, ObjectMeta, Payload,
                    chunk_object, fnv1a64, synthetic_object)
from .client import LocalCache, StashClient
from .controlplane import (AdmissionQueue, AnalyticQueue, CircuitBreaker,
                           ControlPlane, ControlPlaneSpec, ControlStats,
                           fair_shares)
from .federation import (Federation, FederationSpec, SiteSpec, TierSpec,
                         build_fleet_federation, build_osdf_federation,
                         build_osg_federation, site_tiers,
                         OSG_SITE_PROFILES)
from .indexer import Catalog, Indexer
from .monitoring import (CacheHealthMonitor, CacheUsagePacket, DecayGauge,
                         FetchRollup, FileClose, FileOpen, MessageBus,
                         MonitorCollector, SpaceSavingTopK, SweepAggregator,
                         TransferRecord, UsageAggregator, UserLogin,
                         consumer_table, experiment_of)
from .namespace import Namespace
from .origin import ChunkStore, Origin
from .policies import (AdmissionPolicy, EVICTION_POLICIES, EvictionPolicy,
                       FIFOPolicy, LFUPolicy, LRUPolicy, SizeAwareAdmission,
                       TTLPolicy, make_eviction_policy)
from .proxy import HTTPProxy
from .redirector import Redirector, RedirectorGroup, RedirectorPair
from .ring import CacheGroup, GroupStats, HashRing
from .routing import (RANKING_POLICIES, ProbeRankingPolicy, RankingPolicy,
                      StaticRankingPolicy, make_ranking_policy,
                      ranked_caches)
from .simclient import (OutageEvent, OutageSchedule, ScenarioEngine,
                        SimStashClient, apply_outage, first_of,
                        tier_tallies)
from .simulator import (DownloadResult, FluidFlowSim, direct_download,
                        fetch_chunks, proxy_download, sparse_flow_problem,
                        stash_download)
from .topology import BandwidthProfile, Coord, GeoIPService, Link, Node, Topology
from .transfer import NetworkModel, TransferStats
from .workload import (FILESIZE_PERCENTILES, PAPER_TABLE3, PROBE_10GB,
                       USAGE_BY_EXPERIMENT, AccessRequest, PercentileSampler,
                       abusive_workload, checkpoint_restart_workload,
                       dataloader_workload, evaluation_fileset,
                       flash_crowd_workload, generate_workload,
                       herd_workload, shard_serving_workload, split_bytes,
                       storm_workload)
from .writeback import WritebackCache

__all__ = [n for n in dir() if not n.startswith("_")]
