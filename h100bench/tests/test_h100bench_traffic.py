"""The generator: the same seed gives the same operands, any seed up to
past 2**32 works, the sets differ, and phi sets the difficulty."""
import pytest
import torch

from h100bench import traffic

MIX = {"m": 40, "n": 24, "k": 32, "phi": -1, "c": True, "operand_sets": 2}


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_same_seed_same_operands(dtype):
    seed = 2 ** 33 + 5
    one = traffic.operand_sets(MIX, dtype, seed, "cpu")
    two = traffic.operand_sets(MIX, dtype, seed, "cpu")
    other = traffic.operand_sets(MIX, dtype, seed + 1, "cpu")
    for s in range(2):
        for name, shape in (("a", (40, 32)), ("b", (32, 24)), ("c", (40, 24))):
            assert one[s][name].shape == shape
            assert one[s][name].dtype == getattr(torch, dtype)
            assert torch.equal(one[s][name], two[s][name])
            assert not torch.equal(one[s][name], other[s][name])
    assert not torch.equal(one[0]["a"], one[1]["a"])


def test_no_c_unless_the_mix_gives_it():
    sets = traffic.operand_sets(dict(MIX, c=False), "float64", 1, "cpu")
    assert all(s["c"] is None for s in sets)


def test_phi_spreads_the_exponents():
    gen = torch.Generator().manual_seed(3)
    normal = traffic.phi_matrix(gen, 256, 256, -1, torch.float64)
    wide = traffic.phi_matrix(gen, 256, 256, 4, torch.float64)
    assert abs(normal.mean()) < 0.05 and abs(normal.std() - 1) < 0.05
    def spread(x):
        return torch.log2(x.abs().max() / x.abs().median())
    assert spread(wide) > 2 * spread(normal)
