"""Baseline indexes the paper compares NFL against, plus a registry.

Own copies of ``repro.index`` (the port imports nothing of the JAX
package): B-Tree, RMI, PGM, ALEX and LIPP, host-side numpy and Python,
expression for expression, so both packages build the same structures
and answer alike.  They run no kernel."""

from repro_torch.index.base import BaseIndex
from repro_torch.index.btree import BTree
from repro_torch.index.pgm import PGMIndex
from repro_torch.index.alex import ALEXIndex
from repro_torch.index.lipp import LIPPIndex
from repro_torch.index.rmi import RMI

REGISTRY = {
    "btree": BTree,
    "pgm": PGMIndex,
    "alex": ALEXIndex,
    "lipp": LIPPIndex,
    "rmi": RMI,
}


def make_index(name: str, **kwargs) -> BaseIndex:
    return REGISTRY[name](**kwargs)


__all__ = ["BaseIndex", "BTree", "PGMIndex", "ALEXIndex", "LIPPIndex", "RMI",
           "REGISTRY", "make_index"]
