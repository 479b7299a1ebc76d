from .hypergraph import Hypergraph, connected_components

__all__ = ["Hypergraph", "connected_components"]
