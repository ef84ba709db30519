"""Repo-root shim: ``import loam`` resolves to the reference-compatible API.

Lets code written against the reference's pybind11 module run unchanged
from a checkout of this repo. See ``loam_jax/compat.py``.
"""

from loam_jax.compat import *  # noqa: F401,F403
from loam_jax.compat import __all__  # noqa: F401
