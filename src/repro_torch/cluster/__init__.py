"""Cloud-native serving cluster (paper §III/§IV applied to serving).

Replicated ``ServingEngine``s behind a pluggable ``ControlPlane``:
in-flight requests are migratable ``WorkUnit``s (one pack/unpack
lifecycle), and placement, SLO-aware preemption and cost-aware elastic
scaling are swappable policies over a read-only ``ClusterView``; a
``VerticalScalingPolicy`` seam adds in-place replica resize on top
(``repro.vertical`` supplies the recommenders and QoS classes).
Chaos faults (hard kills, stragglers, contention, endpoint failures)
are survived through periodic ``CheckpointPolicy`` snapshots, a
heartbeat ``FailureDetector``, and ``StragglerPolicy`` quarantine.

A copy of ``repro.cluster`` over the port's engine, stores and
runtime, with the same names.
"""

from repro_torch.serving.workunit import WorkUnit

from repro_torch.cluster.autoscaler import Autoscaler
from repro_torch.cluster.checkpoint import CheckpointPolicy, CheckpointRecord
from repro_torch.cluster.cluster import ServingCluster
from repro_torch.cluster.control import (BacklogScaling, ClusterView,
                                         ControlPlane, CostAwareScaling,
                                         MigrationPlan, PlacementPolicy,
                                         PreemptOrder, PreemptionPolicy,
                                         PREEMPTION_POLICIES, ResizeOrder,
                                         ResumeOrder, ScaleDecision,
                                         ScalingPolicy, SCALING_POLICIES,
                                         SLOPreemption, VerticalScalingPolicy)
from repro_torch.cluster.endpoint import (DeviceEndpoint, EndpointUnavailable,
                                          ENDPOINTS, HostEndpoint,
                                          MigrationEndpoint, make_endpoint)
from repro_torch.cluster.health import (FailureDetector, QuarantineOrder,
                                        ReleaseOrder, StragglerPolicy)
from repro_torch.cluster.metrics import ClusterMetrics, VirtualClock
from repro_torch.cluster.replica import InstanceType, Replica, ReplicaState
from repro_torch.cluster.router import (DeadlineAwareRouter, RateAwareRouter,
                                        RoundRobinRouter, Router, ROUTERS)
