"""Vertical elasticity: in-place replica resize + QoS-classed capacity.

Three parts (see ISSUE/README "Vertical elasticity & QoS"):

* the resize *mechanism* lives on the engines
  (``ServingEngine.resize`` / ``SimEngine.resize`` /
  ``Replica.resize``) — repack through the canonical ``SlotSnapshot``
  path, no drain, surviving streams bit-identical;
* the QoS *contract* (``qos.py``): ``SLOClass`` -> Guaranteed /
  Burstable / BestEffort with door-gating and eviction order;
* the resize *policy* (``policy.py``): fixed-threshold vs
  sliding-window recommenders behind the ``ControlPlane.vertical``
  seam (``repro_torch.cluster.control.VerticalScalingPolicy``).

Port of ``repro.vertical``, with the same names; the resize mechanism
is the port's engines' (``ServingEngine.resize`` on the card).
"""

from repro_torch.cluster.control import ResizeOrder, VerticalScalingPolicy

from repro_torch.vertical.policy import (VERTICAL_POLICIES,
                                         FixedThresholdVertical,
                                         SlidingWindowVertical)
from repro_torch.vertical.qos import (BEST_EFFORT, BURSTABLE, GUARANTEED,
                                      QOS_CLASSES, QoSClass, QoSPolicy,
                                      qos_for)

__all__ = [
    "ResizeOrder", "VerticalScalingPolicy",
    "FixedThresholdVertical", "SlidingWindowVertical",
    "VERTICAL_POLICIES",
    "QoSClass", "QoSPolicy", "qos_for",
    "GUARANTEED", "BURSTABLE", "BEST_EFFORT", "QOS_CLASSES",
]
