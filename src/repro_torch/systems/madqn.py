"""MADQN: independent multi-agent DQN (Tampuu et al. 2017), port of `repro.systems.madqn`.

Optionally stabilised with policy fingerprints (Foerster et al. 2017c)
through ``OffPolicyConfig(fingerprint=True)``, the registry's ``madqn-fp``.
The recurrent variant over sequence replay (``rec_madqn``) is not ported
yet.
"""
from repro_torch.systems.offpolicy import OffPolicyConfig, make_offpolicy_system


def make_madqn(env, cfg: OffPolicyConfig = OffPolicyConfig()):
    """Build independent double-DQN learners (optionally fingerprinted)."""
    return make_offpolicy_system(env, cfg, mixer=None, name="madqn")
