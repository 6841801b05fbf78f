"""Compiled-kernel checks at real widths; they need a CUDA GPU.

The pytest run is held to the CPU (tests/conftest.py), so these skip
there; `python chip_smoke.py` runs the same checks (tests/device_checks)
on a card.
"""

import pytest

from tests import device_checks
from tests.conftest import make_corpus

pytestmark = pytest.mark.gpu


def test_pass1_256_streams_of_64k(gpu):
    raws = [make_corpus(("text", "random", "pattern")[i % 3], 65536,
                        seed=i) for i in range(256)]
    device_checks.check_decode(raws)


def test_pass1_1mib_cap_bucket(gpu):
    raws = [make_corpus("text", 1 << 20, seed=1),
            make_corpus("random", (1 << 20) - 256, seed=2)]
    device_checks.check_decode(raws)


def test_device_checksums_match_zlib(gpu):
    device_checks.check_checksums(make_corpus("text", 3 << 20, seed=3))
