"""The port's expression evaluator against the JAX reference's: values
and result dtypes on generated expressions over one seeded table."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.dataflow import expr as RE  # noqa: E402
from repro.dataflow import table as RT  # noqa: E402
from repro_torch.dataflow import expr as TE  # noqa: E402
from repro_torch.dataflow import table as TT  # noqa: E402

N = 512


def _tables(seed=0):
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "delta"]
    cols = {
        "i": rng.integers(-20, 20, N).astype(np.int32),
        "j": rng.integers(-3, 4, N).astype(np.int32),     # has zeros
        "f": rng.uniform(-10, 10, N).astype(np.float32),
        "g": rng.integers(-2, 3, N).astype(np.float32),   # has zeros
        "s": RT.encode_strings([words[k] for k in
                                rng.integers(0, 4, N)]),
    }
    valid = rng.random(N) < 0.9
    ref = RT.Table({n: jnp.asarray(a) for n, a in cols.items()},
                   jnp.asarray(valid))
    port = TT.Table.from_numpy(cols, valid=valid, device="cpu")
    return ref, port


_ARITH = ["add", "sub", "mul", "div", "mod"]
_CMP = ["eq", "ne", "lt", "le", "gt", "ge"]


def _gen(rng, E, depth):
    """A random numeric expression in module E's node types."""
    if depth == 0 or rng.random() < 0.3:
        r = rng.random()
        if r < 0.5:
            return E.Col(["i", "j", "f", "g"][rng.integers(0, 4)])
        if r < 0.75:
            return E.Const(int(rng.integers(-5, 6)))
        return E.Const(float(np.round(rng.uniform(-5, 5), 2)))
    if rng.random() < 0.15:
        return E.Cast(_gen(rng, E, depth - 1),
                      ["int32", "float32"][rng.integers(0, 2)])
    op = _ARITH[rng.integers(0, len(_ARITH))]
    return E.BinOp(op, _gen(rng, E, depth - 1), _gen(rng, E, depth - 1))


def _pred(rng, E, depth):
    if depth == 0 or rng.random() < 0.4:
        if rng.random() < 0.2:
            return E.BinOp(["eq", "ne"][rng.integers(0, 2)], E.Col("s"),
                           E.Const(["alpha", "gamma"][rng.integers(0, 2)]))
        return E.BinOp(_CMP[rng.integers(0, len(_CMP))],
                       _gen(rng, E, 2), _gen(rng, E, 2))
    return E.BinOp(["and", "or"][rng.integers(0, 2)],
                   _pred(rng, E, depth - 1), _pred(rng, E, depth - 1))


def _check(r, p):
    r = np.asarray(r)
    p = p.numpy()
    assert p.dtype == r.dtype, (p.dtype, r.dtype)
    if r.dtype.kind == "f":
        np.testing.assert_allclose(p, r, rtol=1e-6, atol=1e-6,
                                   equal_nan=True)
    else:
        np.testing.assert_array_equal(p, r)


@pytest.mark.parametrize("seed", range(4))
def test_generated_numeric_expressions(seed):
    ref, port = _tables(seed)
    for k in range(8):
        e_r = _gen(np.random.default_rng((seed, k)), RE, 3)
        e_p = _gen(np.random.default_rng((seed, k)), TE, 3)
        assert e_r.key() == e_p.key()
        _check(e_r.eval(ref), e_p.eval(port))


@pytest.mark.parametrize("seed", range(4))
def test_generated_predicates(seed):
    ref, port = _tables(seed)
    for k in range(8):
        p_r = _pred(np.random.default_rng((seed, k)), RE, 3)
        p_p = _pred(np.random.default_rng((seed, k)), TE, 3)
        assert p_r.key() == p_p.key()
        assert RE.pred_normal_key(p_r) == TE.pred_normal_key(p_p)
        _check(p_r.eval(ref), p_p.eval(port))


def test_promotion_rules_match_jax():
    """int32 with a Python float gives float32, int/int gives float32,
    and an int constant keeps an int32 column int32 (torch.tensor(1)
    alone would be int64)."""
    ref, port = _tables()
    cases = [
        (RE.Col("i") * 1.5, TE.Col("i") * 1.5),
        (RE.Col("i") / RE.Col("j"), TE.Col("i") / TE.Col("j")),
        (RE.Col("i") % RE.Col("j"), TE.Col("i") % TE.Col("j")),
        (RE.Col("f") % RE.Col("g"), TE.Col("f") % TE.Col("g")),
        (RE.Col("i") + 1, TE.Col("i") + 1),
        (RE.Cast(RE.Col("i") < 3, "int32") * RE.Col("j"),
         TE.Cast(TE.Col("i") < 3, "int32") * TE.Col("j")),
        (RE.Col("s") == "beta", TE.Col("s") == "beta"),
        (RE.Const(1), TE.Const(1)),
    ]
    for r, p in cases:
        _check(r.eval(ref), p.eval(port))
    assert TE.Const(1).eval(port).dtype == torch.int32
    assert TE.Const(2.5).eval(port).dtype == torch.float32


def test_cnf_and_implication_are_the_reference():
    p_r = (RE.Col("i") > 5) & ((RE.Col("f") < 1.0) | (RE.Col("j") == 2))
    q_r = RE.Col("i") > 3
    p_t = (TE.Col("i") > 5) & ((TE.Col("f") < 1.0) | (TE.Col("j") == 2))
    q_t = TE.Col("i") > 3
    assert RE.implies(p_r, q_r) and TE.implies(p_t, q_t)
    assert RE.residual_pred(p_r, q_r).key() == \
        TE.residual_pred(p_t, q_t).key()
    assert RE.pred_columns(p_r) == TE.pred_columns(p_t)
