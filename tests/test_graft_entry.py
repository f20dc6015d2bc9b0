"""Driver contract: entry() compiles single-chip; dryrun_multichip on 8 CPUs."""

import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as graft  # noqa: E402


def test_entry_compiles():
    fn, args = graft.entry()
    compiled = jax.jit(fn).lower(*args).compile()
    assert compiled is not None


def test_dryrun_multichip_8():
    graft.dryrun_multichip(8)


def test_dryrun_multichip_2():
    graft.dryrun_multichip(2)
