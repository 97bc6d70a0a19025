"""The plain Philox contract (`ops/philox.py`) and the device seed (`rng`).

Each kernel that draws noise ends its Philox counter in its own stream word,
so no two kernels' draws share a counter. The bit-for-bit tests hold each
kernel only to its own plain version and would not see two kernels on one
word; here the table's words are held distinct, to the last counter word of
each helper of `csrc/philox.cuh`, and to the word each wrapper's plain noise
draws on. The layering is checked on the source: every wrapper takes its
Philox code from `ops/philox.py` alone, and `rng.device_seed` is the one
device-seed function of the package.
"""

import ast
import re
from pathlib import Path

import pytest
import torch

from common_tpu_torch import rng
from common_tpu_torch.ops import gaussian_assign as ga
from common_tpu_torch.ops import hdp_assign as ha
from common_tpu_torch.ops import linear_assign as la
from common_tpu_torch.ops import philox
from common_tpu_torch.ops import slice_update as su
from common_tpu_torch.rng import device_seed

PKG = Path(philox.__file__).resolve().parent.parent
OPS = PKG / "ops"
SEED = torch.tensor([123457], dtype=torch.int32)

# each stream word's helper in csrc/philox.cuh, and its wrapper's plain noise
STREAMS = {
    "GAUSSIAN_STREAM": ("gumbel", ga, lambda: ga.philox_gumbel(SEED, torch.arange(5, 9), 6, chain=2)),
    "LINEAR_STREAM": ("linear_words", la, lambda: la.linear_philox_gumbel(SEED, torch.arange(5, 9), 7)),
    "SLICE_STREAM": ("slice_words", su, lambda: su.slice_draws(SEED, 65)),
    "HDP_STREAM": ("hdp_words", ha, lambda: ha.hdp_philox_gumbel(SEED, torch.arange(2**32 - 2, 2**32 + 2), 9)),
}


def _imports(path: Path):
    """(module, names) of each `import` and `from ... import` of a source file."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [(a.name, ()) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            out.append((node.module or "", tuple(a.name for a in node.names)))
    return out


def test_the_stream_words_are_distinct_and_are_philox_cuh_s():
    words = {name: v for name, v in vars(philox).items() if name.endswith("_STREAM")}
    assert sorted(words) == sorted(STREAMS)
    assert len(set(words.values())) == len(words)
    cuh = (PKG / "csrc" / "philox.cuh").read_text()
    for name, (helper, _, _) in STREAMS.items():
        body = re.search(rf"__forceinline__ \w+ {helper}\((.*?)\n}}", cuh, re.S)
        assert body, helper
        (last,) = re.findall(r"make_uint4\([^;]*?,\s*(\d+)u\)", body.group(1))
        assert int(last) == words[name], (name, helper)


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_each_wrapper_draws_its_plain_noise_on_its_own_word(stream, monkeypatch):
    """The counters each wrapper's plain noise hands to Philox end in its
    table word, and the recorded calls give the same draws."""
    _, module, noise = STREAMS[stream]
    want = noise()
    last_words = []

    def recorded(ctr, key):
        last_words.append(torch.as_tensor(ctr[3]))
        return philox.philox4x32_10(ctr, key)

    monkeypatch.setattr(module, "philox4x32_10", recorded)
    assert torch.equal(noise(), want)
    assert last_words and all(bool((w == getattr(philox, stream)).all()) for w in last_words)


@pytest.mark.parametrize("wrapper", sorted(p.name for p in OPS.glob("*.py")
                                           if p.name not in ("__init__.py", "_build.py", "philox.py")))
def test_a_wrapper_takes_philox_from_ops_philox_alone(wrapper):
    """No wrapper imports another kernel's wrapper, or declares a stream
    word or a Philox function of its own."""
    path = OPS / wrapper
    for module, names in _imports(path):
        if module == "common_tpu_torch.ops":
            assert set(names) <= {"_build", "philox"}, (wrapper, names)
        elif module.startswith("common_tpu_torch.ops."):
            assert module == "common_tpu_torch.ops.philox", (wrapper, module)
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.FunctionDef):
            assert node.name not in {"philox4x32_10", "philox_key", "uniform_from_bits", "gumbel_from_bits"}
        elif isinstance(node, ast.Assign):
            targets = {t.id for t in node.targets if isinstance(t, ast.Name)}
            assert not {t for t in targets if t.endswith("STREAM") or "MASK32" in t}, (wrapper, targets)


def test_rng_device_seed_is_the_one_device_seed():
    """No module but `rng` defines a device seed, and the seed is one int32
    `torch.randint` on the generator's device, consumed in order."""
    defs = sorted(f"{p.relative_to(PKG)}:{node.name}" for p in PKG.rglob("*.py")
                  for node in ast.walk(ast.parse(p.read_text()))
                  if isinstance(node, ast.FunctionDef) and "device_seed" in node.name)
    assert defs == ["rng.py:device_seed"]
    g, h = rng(5, "cpu").generator, rng(5, "cpu").generator
    seed = device_seed(g, g.device)
    assert seed.dtype == torch.int32 and seed.shape == (1,)
    assert torch.equal(seed, torch.randint(0, 2**31 - 1, (1,), generator=h, dtype=torch.int32))
    assert torch.equal(torch.rand(3, generator=g), torch.rand(3, generator=h))

