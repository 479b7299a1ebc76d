from .hypergraph import Dag, Hypergraph, connected_components

__all__ = ["Dag", "Hypergraph", "connected_components"]
