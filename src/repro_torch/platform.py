"""Public export surface for the unified control-plane API.

    from repro_torch.platform import Platform, PlatformConfig

``Platform.build(scenario=..., config=...)`` assembles a validated
control plane (world, cluster, scheduler, autoscaler, simulation,
observer hub) from a ``PlatformConfig`` tree or a plain manifest dict;
schedulers / scenario kinds / trace programs / routers are selected
through name-based registries, and the autoscaler and simulator consume
their collaborators only through the capability protocols
(``CapacityProvider``, ``ReleasePicker``, ``LogicalStartPicker``,
``Router``) — see ``repro_torch.core.platform``.

    python -m repro_torch.platform  # smoke on the card: every
                                    # registered scheduler x one
                                    # scenario, built from pure config
                                    # dicts, 30 ticks
"""
from .core.platform import *            # noqa: F401,F403
from .core.platform import __all__      # noqa: F401

if __name__ == "__main__":
    from .core.platform import smoke
    smoke()
