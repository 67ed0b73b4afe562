"""VDN (Sunehag et al. 2017): MADQN under additive mixing (port of `repro.systems.vdn`)."""
from repro_torch.core.modules.mixing import AdditiveMixing
from repro_torch.systems.offpolicy import OffPolicyConfig, make_offpolicy_system


def make_vdn(env, cfg: OffPolicyConfig = OffPolicyConfig()):
    """Build VDN: agent Q-nets under additive value decomposition."""
    return make_offpolicy_system(env, cfg, mixer=AdditiveMixing(), name="vdn")
