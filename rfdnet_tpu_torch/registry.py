"""Name -> class and function registries (config keys select modules and
losses).

Counterpart of `rfdnet_tpu/registry.py`: the same names, mapped to the
port's classes and functions, so that the strings a config gives under
`model.<submodule>.method` / `.loss` resolve here too.
"""

from __future__ import annotations


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._map: dict[str, type] = {}

    def register(self, cls=None, *, name: str | None = None):
        def deco(c):
            self._map[name or c.__name__] = c
            return c

        if cls is None:
            return deco
        return deco(cls)

    def get(self, name: str):
        if name not in self._map:
            raise KeyError(
                f"{self.name} registry has no '{name}' "
                f"(known: {sorted(self._map)})"
            )
        return self._map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._map


METHODS = Registry("method")
MODULES = Registry("module")
LOSSES = Registry("loss")


def _populate() -> None:
    from .models import losses as L
    from .models.backbone import Pointnet2Backbone
    from .models.iscnet import ISCNet
    from .models.occnet import ONet
    from .models.proposal import ProposalModule
    from .models.skip_propagation import SkipPropagation
    from .models.voting import VotingModule

    METHODS.register(ISCNet, name="ISCNet")
    MODULES.register(Pointnet2Backbone, name="Pointnet2Backbone")
    MODULES.register(VotingModule, name="VotingModule")
    MODULES.register(ProposalModule, name="ProposalModule")
    MODULES.register(SkipPropagation, name="SkipPropagation")
    MODULES.register(ONet, name="ONet")
    LOSSES.register(L.detection_loss, name="DetectionLoss")
    LOSSES.register(L.onet_loss, name="ONet_Loss")
    LOSSES.register(L.chamfer_loss, name="ChamferDist")
    LOSSES.register(L.boxnet_detection_loss, name="BoxNetDetectionLoss")


_populate()
