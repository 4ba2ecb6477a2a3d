"""The generator: the same seed gives the same inputs; every seed gives
a batch's lanes in another order; batches of a window differ; seeds past
32 bits work."""

import torch

from harness import cells, traffic

CONFIG = cells.config("rocket6dof_k50")
MIX = cells.traffic("seeded_b512")


def _rows(fields):
    return torch.cat([fields["r_init"], fields["v_init"],
                      fields["m_wet"][:, None]], dim=1)


def test_same_seed_same_inputs():
    a = traffic.batch(CONFIG, MIX, 2 ** 33 + 5, 0, "cpu")
    b = traffic.batch(CONFIG, MIX, 2 ** 33 + 5, 0, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["r_init"].dtype == torch.float32
    assert a["r_init"].shape == (MIX["batch"], 3)


def test_pool_is_the_same_work_in_another_order():
    a = _rows(traffic.batch(CONFIG, MIX, 11, 3, "cpu"))
    b = _rows(traffic.batch(CONFIG, MIX, 2 ** 31 + 12, 3, "cpu"))
    assert not torch.equal(a, b)
    key = lambda t: t[torch.argsort(t[:, 0])]  # noqa: E731
    assert torch.equal(key(a), key(b))
    c = _rows(traffic.batch(CONFIG, MIX, 11, 4, "cpu"))
    shared = torch.isin(c[:, 0], a[:, 0]).sum()
    assert int(shared) == 0


def test_dispersion_stds():
    a = _rows(traffic.batch(CONFIG, MIX, 11, 0, "cpu")).double()
    base = torch.tensor(CONFIG["scenario"]["r_init"], dtype=torch.float64)
    std = (a[:, :3] - base).std(0)
    assert torch.allclose(std, torch.full((3,), 0.2, dtype=std.dtype),
                          rtol=0.15)
    m = a[:, 6] / CONFIG["scenario"]["m_wet"] - 1.0
    assert abs(float(m.std()) - 0.03) < 0.0045


def test_undispersed_fields_keep_the_scenario():
    f = traffic.batch(CONFIG, MIX, 7, 0, "cpu")
    assert torch.all(f["T_max"] == CONFIG["scenario"]["T_max"])
    n = traffic.nominal(CONFIG, "cpu")
    assert n["r_init"].shape == (1, 3)
