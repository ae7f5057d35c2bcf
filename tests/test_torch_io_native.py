"""The port's native CSV writer against the JAX package's: the same
DataFrame gives the same bytes (``%.9g`` floats), ``generate_dataset``
writes through it, and pandas takes over only where the JAX module's does
(no compiler, or a library that does not load)."""

import numpy as np
import pandas as pd
import pytest

from nbody_tpu.data import io_native as jio
from nbody_tpu_torch.data import generate as tgen
from nbody_tpu_torch.data import io_native as tio
from nbody_tpu_torch.data.schema import CSV_FIELDS


def _frame(rows=40, seed=0):
    """Rows of the schema with the values a writer must get right: float32
    and float64 magnitudes from 1e-30 to 1e30, negative zero, NaN energies,
    two scene types and int64 steps past 2^31."""
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({c: rng.normal(size=rows) * 10.0 ** rng.integers(-30, 30, rows)
                       for c in CSV_FIELDS})
    df["scene"] = np.arange(rows) // 10
    df["scene_type"] = np.where(np.arange(rows) % 3 == 0, "disk", "spiral")
    df["step"] = np.arange(rows, dtype=np.int64) * (1 << 28)
    df["x"] = rng.normal(size=rows).astype(np.float32)
    df.loc[1, "y"] = -0.0
    df.loc[2:5, ["u", "k"]] = np.nan
    return df[CSV_FIELDS]


def test_native_bytes_equal_the_jax_writer(tmp_path):
    assert tio.native_available() and jio.native_available()
    df = _frame()
    tio.write_csv(df, str(tmp_path / "port.csv"))
    jio.write_csv(df, str(tmp_path / "jax.csv"))
    got = (tmp_path / "port.csv").read_bytes()
    assert got == (tmp_path / "jax.csv").read_bytes()
    assert got.splitlines()[0] == ",".join(CSV_FIELDS).encode()
    back = pd.read_csv(tmp_path / "port.csv")
    np.testing.assert_allclose(back["mass"], df["mass"], rtol=1e-8)  # %.9g


def test_dataset_csv_is_the_jax_writers(tmp_path):
    """``generate_dataset`` writes its CSV natively: the JAX writer gives the
    same bytes for the frame read back, and no float64 repr is left."""
    out = str(tmp_path / "d.csv")
    tgen.generate_dataset(tgen.scenario_product(n_bodies=[5, 9], steps=4, seed=3,
                                                sim_type="spiral"), out, verbose=False,
                          device="cpu")
    jio.write_csv(pd.read_csv(out), str(tmp_path / "j.csv"))
    text = (tmp_path / "d.csv").read_bytes()
    assert text == (tmp_path / "j.csv").read_bytes()
    assert b",0.00999999978," in text  # the black hole's float32 mass, as %.9g


def test_library_built_under_build_not_native():
    lib = tio._build()
    assert lib.parent == tio.BUILD_DIR and lib.parts[-3:-1] == ("build", "native")


@pytest.mark.parametrize("how", ["missing", "no_compiler"])
def test_pandas_fallback(tmp_path, monkeypatch, how):
    """No library (or no compiler to build it): pandas writes the file."""
    monkeypatch.setattr(tio, "_lib", None)
    monkeypatch.setattr(tio, "_lib_tried", how == "missing")
    if how == "no_compiler":
        monkeypatch.setattr(tio, "BUILD_DIR", tmp_path / "empty")
        monkeypatch.setattr(tio.shutil, "which", lambda name: None)
    assert not tio.native_available()
    df = _frame(12)
    tio.write_csv(df, str(tmp_path / "p.csv"))
    df.to_csv(tmp_path / "want.csv", index=False)
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "want.csv").read_bytes()
