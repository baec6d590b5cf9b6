"""The plain reference agrees with the program at small sizes, and its
proof verifier rejects a forged proof."""
import numpy as np
import pytest

from bench.reference import plain


@pytest.fixture
def engine():
    from repro_torch.core import ForkBase, hashing
    from repro_torch.kernels import ops
    ops.set_device("cpu")
    hashing.use_fphash()
    return ForkBase()


@pytest.mark.parametrize("n", [0, 1, 4095, 50_000, 140_000])
def test_blob_roots_and_uids_agree(engine, n):
    from repro_torch.core import FBlob
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    uid = engine.put("d", FBlob(data.tobytes()))
    raw = engine.store.get(uid)
    meta = plain.Meta.decode(raw)
    assert meta.data == plain.blob_root(data, plain.Chunking(), "cpu")
    assert meta == plain.Meta(plain.BLOB, b"d", meta.data, 0, (), b"")
    assert plain.cid(meta.encode(), "cpu") == uid


@pytest.mark.parametrize("n", [1, 300, 5000])
def test_map_roots_and_proofs_agree(engine, n):
    from repro_torch.core import FMap
    rng = np.random.default_rng(n)
    items = {b"kv/key%d" % i: rng.bytes(64) for i in range(n)}
    engine.put("m", FMap(items))
    root = engine.get("m").obj.data
    assert root == plain.map_root(sorted(items.items()), plain.Chunking(),
                                  "cpu")
    key = b"kv/key%d" % (n // 2)
    proof = engine.prove_member("m", item_key=key).to_bytes()
    assert plain.member_by_key(root, proof, key, "cpu") == items[key]
    forged = bytearray(proof)
    forged[-5] ^= 1
    with pytest.raises(plain.Rejected):
        plain.member_by_key(root, bytes(forged), key, "cpu")
    with pytest.raises(plain.Rejected):
        plain.member_by_key(root, proof, b"kv/other", "cpu")


def test_cids_agree_with_the_kernels_plain_version():
    import torch

    from repro_torch.kernels import ops
    ops.set_device("cpu")
    raws = [b"", b"a", bytes(range(256)) * 17, b"x" * 4096, b"y" * 4097]
    assert plain.cids(raws, "cpu") == [ops.content_hash(r) for r in raws]
    assert torch.get_num_threads() == 1
