"""What the port's cross-package cluster tests share.

One scenario runs through ``repro`` and through ``repro_torch``, each
package building its own objects, and the two runs are compared as
records: the ``EventLoop`` journal digest and event count, the timeline,
``ClusterMetrics.summary()`` without the keys that hold wall-clock
seconds, and the per-request streams.
"""

import dataclasses

import jax
import numpy as np

import repro.cluster as jcluster
import repro.launch.serve as jserve
import repro.market as jmarket
import repro.runtime as jruntime
import repro.serving.engine as jengine
import repro.serving.workload as jworkload
import repro.vertical as jvertical
import repro_torch.cluster as tcluster
import repro_torch.launch.serve as tserve
import repro_torch.market as tmarket
import repro_torch.runtime as truntime
import repro_torch.serving.engine as tengine
import repro_torch.serving.workload as tworkload
import repro_torch.vertical as tvertical
from repro.configs import get_config as jax_config
from repro.models import transformer as jtransformer
from repro.models.schema import init_params as jinit_params
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_numpy

# Summary keys that hold real (wall-clock) seconds: the stores' stage
# times, and the market ledger's sum of the drains' stage times.
WALL_KEYS = ("preempt_stage_s", "interruption_overhead_s",
             "recovery_restore_s", "checkpoint_stage_s", "resize_stage_s",
             "spot_interruption_overhead_s")


@dataclasses.dataclass
class Pkg:
    cluster: object
    runtime: object
    engine: object
    workload: object
    serve: object
    market: object
    vertical: object
    dev: dict


JAX = Pkg(jcluster, jruntime, jengine, jworkload, jserve, jmarket,
          jvertical, {})
TORCH = Pkg(tcluster, truntime, tengine, tworkload, tserve, tmarket,
            tvertical, {"device": "cpu"})


def virtual(summary):
    """``summary()`` without the keys that hold real wall-clock seconds."""
    return {k: v for k, v in summary.items() if k not in WALL_KEYS}


def record(cl, reqs, out):
    return dict(digest=cl.loop.journal_digest, events=cl.loop.dispatched,
                timeline=list(cl.timeline), summary=virtual(out),
                streams=[list(r.out_tokens) for r in reqs])


def f32_models():
    """Reduced float32 granite-8b with the JAX weights in both packages:
    ``{"jax": (cfg, params), "torch": (cfg, params)}``."""
    jcfg = jax_config("granite-8b").reduced().with_(compute_dtype="float32")
    tcfg = get_config("granite-8b").reduced().with_(compute_dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    schema = jtransformer.model_schema(jcfg)
    jparams = jax.jit(lambda key: jinit_params(schema, key,
                                               jcfg.param_dtype))(
        jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    return {"jax": (jcfg, jparams), "torch": (tcfg, tparams)}
