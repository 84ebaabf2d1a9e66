"""Node assembly (counterpart: tendermint_tpu/node/__init__.py; reference:
node/, makeNode and OnStart), the node key, and the device seam
(node/device.py)."""

from .key import NodeKey
from .node import Node, make_node

__all__ = ["Node", "NodeKey", "make_node"]
