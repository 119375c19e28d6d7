"""Entry-point contract: ``__graft_entry__.dryrun_multichip`` runs one sharded
training step on an n-device mesh, and refuses to run on fewer devices.

Under pytest the conftest provisions an 8-device virtual CPU platform."""

import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as g  # noqa: E402


def test_dryrun_multichip_inline_path():
    assert len(jax.devices()) >= 2
    g.dryrun_multichip(2)


def test_dryrun_multichip_raises_with_too_few_devices():
    with pytest.raises(ValueError, match="needs"):
        g.dryrun_multichip(len(jax.devices()) + 1)
