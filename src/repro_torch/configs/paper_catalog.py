"""The paper's own experimental configurations as selectable configs.

* ``numerical()``   — the §VI-B synthetic setup (|E|=10, |S|=100, impls
  ~U{1..10}, the exact capacity/cost/threshold distributions).
* ``realworld()``   — the §VI-C Table-I setup (six ImageNet classifiers,
  one edge cloud, R=1 placement slot).
* ``zoo_catalog()`` — the beyond-paper catalog mapping the 10 assigned
  architectures onto multi-implementation services.

The reference's :mod:`repro.configs.paper_catalog`, over the port's own
instance generators (byte-identical per seed).
"""
from __future__ import annotations

from repro_torch.core.instance import (PIESInstance, realworld_instance,
                                       synthetic_instance, REALWORLD_CATALOG)


def numerical(n_users: int = 250, seed: int = 0) -> PIESInstance:
    return synthetic_instance(n_users, n_edges=10, n_services=100,
                              max_impls=10, seed=seed)


def realworld(seed: int = 0) -> PIESInstance:
    return realworld_instance(seed=seed)


def zoo_catalog():
    from repro_torch.serving.catalog import default_catalog
    return default_catalog()


TABLE_I = REALWORLD_CATALOG
