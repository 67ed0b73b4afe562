"""QMIX (Rashid et al. 2018): monotonic value factorisation (port of `repro.systems.qmix`)."""
from repro_torch.core.modules.mixing import MonotonicMixing
from repro_torch.systems.offpolicy import OffPolicyConfig, make_offpolicy_system


def make_qmix(env, cfg: OffPolicyConfig = OffPolicyConfig(), embed_dim: int = 32):
    """Build QMIX: agent Q-nets under a monotonic hypernetwork mixer."""
    return make_offpolicy_system(
        env, cfg, mixer=MonotonicMixing(embed_dim=embed_dim), name="qmix"
    )
