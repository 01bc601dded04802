"""Multi-chip sharding tests on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from linemod_pose_estimation.ops import match as M
from linemod_pose_estimation.parallel import mesh as PM
from linemod_pose_estimation.parallel.sharded_match import (
    make_sharded_bank,
    make_sharded_coarse_matcher,
    make_sharded_detect_step,
    pad_bank_features,
)


def random_bank(rng, n, fmax=16, extent=32):
    offs = rng.integers(0, extent, size=(n, fmax, 2)).astype(np.int32)
    oris = rng.integers(0, 8, size=(n, fmax)).astype(np.int32)
    cnt = rng.integers(fmax // 2, fmax + 1, size=(n,)).astype(np.int32)
    live = np.arange(fmax)[None, :] < cnt[:, None]
    size = np.full((n, 2), extent, np.int32)
    return M.LevelFeatures(
        offsets=jnp.asarray(offs), oris=jnp.asarray(oris), live=jnp.asarray(live),
        count=jnp.asarray(cnt), size=jnp.asarray(size),
    )


def random_responses(rng, b, h, w):
    return jnp.asarray(
        rng.choice([0, 3, 4], size=(b, 8, h, w), p=[0.5, 0.25, 0.25]).astype(np.uint8)
    )


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return PM.make_mesh(data=2, bank=4)


def test_sharded_matches_single_device_result(rng, mesh8):
    T, ext = 8, 5
    n, b, h, w = 24, 2, 64, 96
    feats = pad_bank_features(random_bank(rng, n), mesh8.shape["bank"])
    R = random_responses(rng, b, h, w)

    matcher = make_sharded_coarse_matcher(mesh8, T, ext, top_k=16, threshold=0.0)
    cand = matcher(R, feats)

    # Single-device reference.
    for fi in range(b):
        raw = M.coarse_scores(R[fi], feats, T, ext)
        Hc, Wc = raw.shape[1:]
        vpos = M.position_validity(feats.size, T, Hc, Wc)
        ref = M.select_candidates(raw, feats.count, vpos, 0.0, 16)
        got_sims = np.sort(np.asarray(cand.similarity[fi]))[::-1]
        ref_sims = np.sort(np.asarray(ref.similarity))[::-1]
        np.testing.assert_allclose(got_sims, ref_sims, atol=1e-4)
        # The global best must agree exactly (id + cell).
        gb = int(np.argmax(np.asarray(cand.similarity[fi])))
        rb = int(np.argmax(np.asarray(ref.similarity)))
        assert int(cand.template_id[fi][gb]) == int(ref.template_id[rb])
        assert int(cand.cell_y[fi][gb]) == int(ref.cell_y[rb])
        assert int(cand.cell_x[fi][gb]) == int(ref.cell_x[rb])


def test_sharded_detect_step_runs(rng, mesh8):
    """Full production step: raw frames -> preprocess -> bank-sharded GEMM ->
    refine -> ICI merge.  Runs end-to-end on the virtual mesh."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    T0, T1, E1 = 5, 8, 16
    Kc1 = (E1 - 1) // T1 + 1
    sb = make_sharded_bank(
        mesh8, random_bank(rng, 16, extent=E1), random_bank(rng, 16, extent=2 * E1),
        C=8, T1=T1, Kc1=Kc1,
    )
    rgbs = jnp.asarray(rng.integers(0, 255, size=(2, 64, 64, 3), dtype=np.uint8))
    depths = jnp.zeros((2, 64, 64), jnp.float32)
    rgbs = jax.device_put(rgbs, NamedSharding(mesh8, P("data")))
    depths = jax.device_put(depths, NamedSharding(mesh8, P("data")))
    step = make_sharded_detect_step(
        mesh8, T1, Kc1, top_k=8, threshold=0.0, T0=T0, E0=2 * E1
    )
    mat, metrics = step(rgbs, depths, sb)
    assert mat.template_id.shape == (2, 8)
    assert int(metrics["num_matches"]) >= 0
    assert -1.0 <= float(metrics["best_similarity"]) <= 100.0


def test_sharded_bank_fine_g_coupling(rng, mesh8):
    """make_sharded_bank and make_sharded_detect_step must agree on
    fine_g: a mismatched pair fails at BUILD time with a clear error,
    and the fine_g=None pair runs coarse-only end-to-end."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    T0, T1, E1 = 5, 8, 16
    Kc1 = (E1 - 1) // T1 + 1
    f1 = random_bank(rng, 16, extent=E1)
    f0 = random_bank(rng, 16, extent=2 * E1)
    rgbs = jnp.asarray(rng.integers(0, 255, size=(2, 64, 64, 3), dtype=np.uint8))
    depths = jnp.zeros((2, 64, 64), jnp.float32)
    rgbs = jax.device_put(rgbs, NamedSharding(mesh8, P("data")))
    depths = jax.device_put(depths, NamedSharding(mesh8, P("data")))

    # Disabled on both sides: zero-width W_fine placeholder, coarse-only.
    sb_off = make_sharded_bank(mesh8, f1, f0, C=8, T1=T1, Kc1=Kc1, fine_g=None)
    assert sb_off.W_fine.shape[1] == 0
    step_off = make_sharded_detect_step(
        mesh8, T1, Kc1, top_k=8, threshold=0.0, T0=T0, E0=2 * E1, fine_g=None
    )
    mat, _ = step_off(rgbs, depths, sb_off)
    assert mat.template_id.shape == (2, 8)

    # Mismatch (bank fine off, step fine on): clear build-time error.
    step_on = make_sharded_detect_step(
        mesh8, T1, Kc1, top_k=8, threshold=0.0, T0=T0, E0=2 * E1
    )
    with pytest.raises(ValueError, match="fine_g"):
        step_on(rgbs, depths, sb_off)


@pytest.mark.slow
def test_sharded_detect_equals_single_device(rng, mesh8):
    """The sharded step (GEMM coarse + per-shard refine + ICI merge) must
    find the planted template at the same place/score as the single-device
    engine."""
    import sys

    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sys.path.insert(0, "tests")
    from test_match import make_object_patch, plant

    from linemod_pose_estimation.models.detector import Detector
    from linemod_pose_estimation.models.templates import DetectorParams

    patch, mask = make_object_patch(rng)
    src = plant((128, 128, 3), patch, (30, 50))
    src_mask = plant((128, 128), mask, (30, 50))
    det = Detector(DetectorParams(), engine="gather")
    assert det.add_template(src, src_mask, "obj") == 0
    bank = det.bank("obj")
    feats1 = bank.merged_features(1)
    feats0 = bank.merged_features(0)
    T0, T1 = det.params.t_pyramid
    Kc1 = bank.max_cell_extent(1)
    E0 = bank.extent(0)

    sb = make_sharded_bank(mesh8, feats1, feats0, C=8, T1=T1, Kc1=Kc1)
    frames = np.stack([src, plant((128, 128, 3), patch, (38, 34))])
    rgbs = jax.device_put(
        jnp.asarray(frames), NamedSharding(mesh8, P("data"))
    )
    depths = jax.device_put(
        jnp.zeros((2, 128, 128), jnp.float32), NamedSharding(mesh8, P("data"))
    )
    step = make_sharded_detect_step(
        mesh8, T1, Kc1, top_k=8, threshold=90.0, T0=T0, E0=E0
    )
    mat, metrics = step(rgbs, depths, sb)

    # Single-device reference through the same engine.
    ref = det.match(frames[0], 90.0)["obj"]
    assert len(ref) > 0
    rbest = int(np.argmax(ref.similarity))
    ok0 = np.asarray(mat.valid[0])
    assert ok0.any()
    b0 = int(np.argmax(np.where(ok0, np.asarray(mat.similarity[0]), -1.0)))
    assert float(mat.similarity[0][b0]) >= 99.0
    assert (int(mat.x[0][b0]), int(mat.y[0][b0])) == (int(ref.x[rbest]), int(ref.y[rbest]))
    # Frame 1: plant shifted by (-16, +8) from frame 0 -> match shifts too
    # (within the T0-grid reporting offset: the shift is not a multiple of
    # T0, so the walk snaps to the nearest grid point <= 2 px away).
    ok1 = np.asarray(mat.valid[1])
    b1 = int(np.argmax(np.where(ok1, np.asarray(mat.similarity[1]), -1.0)))
    assert abs(int(mat.x[1][b1]) - (int(ref.x[rbest]) - 16)) <= 2
    assert abs(int(mat.y[1][b1]) - (int(ref.y[rbest]) + 8)) <= 2


def test_bank_padding_dead_templates(rng, mesh8):
    feats = random_bank(rng, 10)
    padded = pad_bank_features(feats, 4)
    assert padded.oris.shape[0] == 12
    assert not bool(np.asarray(padded.live[-1]).any())
    assert int(padded.count[-1]) == 0


def test_frame_batcher_and_global_put(rng, mesh8):
    """DCN ingest seam: FrameBatcher round-robins camera sources; the global
    batch shards over the mesh "data" axis via
    make_array_from_process_local_data (multi-host compatible)."""
    from jax.sharding import PartitionSpec as P

    from linemod_pose_estimation.api.service import Frame
    from linemod_pose_estimation.parallel.ingest import FrameBatcher, put_global_batch

    frames = [
        Frame(rgb=np.full((8, 8, 3), i, np.uint8), cloud=np.zeros((8, 8, 3), np.float32))
        for i in range(3)
    ]
    fb = FrameBatcher([lambda i=i: frames[i] for i in range(3)], batch=4)
    rgbs, clouds = fb.next_batch()
    assert rgbs.shape == (4, 8, 8, 3)
    assert [int(r[0, 0, 0]) for r in rgbs] == [0, 1, 2, 0]
    rgbs2, _ = fb.next_batch()  # round-robin continues
    assert int(rgbs2[0, 0, 0, 0]) == 1

    g_rgbs, g_depths = put_global_batch(mesh8, rgbs, clouds[..., 2])
    assert g_rgbs.shape == (4, 8, 8, 3)
    assert g_depths.shape == (4, 8, 8)
    spec = g_rgbs.sharding.spec
    assert spec[0] == "data"
    np.testing.assert_array_equal(np.asarray(g_rgbs), rgbs)


@pytest.mark.slow
def test_row_sharded_matcher_equals_single_device(rng, mesh8):
    """Context-parallel analog: frame rows sharded over the mesh with a
    ppermute halo exchange must reproduce the single-device match exactly."""
    import sys

    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sys.path.insert(0, "tests")
    from test_match import make_object_patch, plant

    from linemod_pose_estimation.models.detector import Detector
    from linemod_pose_estimation.models.templates import DetectorParams
    from linemod_pose_estimation.ops import match as M
    from linemod_pose_estimation.parallel.sharded_match import (
        make_row_sharded_matcher,
    )

    patch, mask = make_object_patch(rng)
    # Stripes must be multiples of both 2*T1 (coarse cells) and T0 (the
    # walk's placement grid): H0/8 = 80 satisfies both.
    H0, W0 = 640, 128
    src = plant((H0, W0, 3), patch, (150, 40))
    src_mask = plant((H0, W0), mask, (150, 40))
    det = Detector(DetectorParams(), engine="gather")
    assert det.add_template(src, src_mask, "obj") == 0
    bank = det.bank("obj")
    T0, T1 = det.params.t_pyramid
    Kc1 = bank.max_cell_extent(1)
    E0 = bank.extent(0)
    feats1, feats0 = bank.merged_features(1), bank.merged_features(0)
    W1 = bank.gemm_weights(1)
    rep = lambda a: jax.device_put(a, NamedSharding(mesh8, P()))
    matcher = make_row_sharded_matcher(
        mesh8, "bank", T1, Kc1, top_k=8, threshold=90.0, T0=T0, E0=E0
    )

    # Stripes are 80 level-0 rows (8 shards); probe plants that land mid-
    # stripe, just ABOVE shard boundaries (the upward-halo case: the refine
    # window must read the previous shard's rows), and at the image top
    # (the global-clip case).
    for (py, px) in [(150, 40), (60, 30), (315, 50), (475, 20), (0, 40)]:
        scene = plant((H0, W0, 3), patch, (py, px))
        pyr = M.preprocess_frame(jnp.asarray(scene), None, T0=T0, T1=T1)
        R0 = jax.device_put(pyr.grad_r0, NamedSharding(mesh8, P(None, "bank")))
        R1 = jax.device_put(pyr.grad_r1, NamedSharding(mesh8, P(None, "bank")))
        mat = matcher(R1, R0, rep(W1), jax.tree.map(rep, feats1),
                      jax.tree.map(rep, feats0))

        ref = det.match(scene, 90.0)["obj"]
        assert len(ref) > 0, (py, px)
        rbest = int(np.argmax(ref.similarity))
        ok = np.asarray(mat.valid)
        assert ok.any(), (py, px)
        b = int(np.argmax(np.where(ok, np.asarray(mat.similarity), -1.0)))
        assert float(mat.similarity[b]) >= float(ref.similarity[rbest]) - 1e-4, (py, px)
        assert (int(mat.x[b]), int(mat.y[b])) == (
            int(ref.x[rbest]), int(ref.y[rbest]),
        ), (py, px)


def test_ring_detect_equals_single_device(rng):
    """Ring-pipelined bank rotation (SURVEY.md §5): frames stay put, bank
    shards rotate with ppermute — after n hops the valid match set equals
    the single-device engine's."""
    import sys

    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    sys.path.insert(0, "tests")
    from test_match import make_object_patch, plant

    from linemod_pose_estimation.models.detector import Detector
    from linemod_pose_estimation.models.templates import DetectorParams
    from linemod_pose_estimation.parallel.sharded_match import (
        make_ring_bank, make_ring_detect_step,
    )

    mesh = Mesh(np.asarray(jax.devices()[:4]), ("ring",))
    patch, mask = make_object_patch(rng)
    det = Detector(DetectorParams(), engine="gather")
    for shift in (0, 4, 9):
        src = plant((128, 128, 3), patch, (30, 40 + shift))
        src_mask = plant((128, 128), mask, (30, 40 + shift))
        assert det.add_template(src, src_mask, "obj") >= 0
    bank = det.bank("obj")
    feats1, feats0 = bank.merged_features(1), bank.merged_features(0)
    T0, T1 = det.params.t_pyramid
    Kc1 = bank.max_cell_extent(1)
    E0 = bank.extent(0)

    rb = make_ring_bank(mesh, "ring", feats1, feats0, C=8, T1=T1, Kc1=Kc1)
    frames = np.stack([
        plant((128, 128, 3), patch, (30, 40)),
        plant((128, 128, 3), patch, (38, 34)),
        plant((128, 128, 3), patch, (10, 80)),
        np.zeros((128, 128, 3), np.uint8),
    ])
    rgbs = jax.device_put(jnp.asarray(frames), NamedSharding(mesh, P("ring")))
    depths = jax.device_put(
        jnp.zeros((4, 128, 128), jnp.float32), NamedSharding(mesh, P("ring"))
    )
    step = make_ring_detect_step(
        mesh, "ring", T1, Kc1, top_k=8, threshold=90.0, T0=T0, E0=E0
    )
    mat = step(rgbs, depths, rb)

    for b in range(4):
        ref = det.match(frames[b], 90.0)["obj"]
        got = {
            (int(t), int(x), int(y), round(float(s), 3))
            for t, x, y, s, v in zip(
                np.asarray(mat.template_id[b]), np.asarray(mat.x[b]),
                np.asarray(mat.y[b]), np.asarray(mat.similarity[b]),
                np.asarray(mat.valid[b]),
            ) if v
        }
        want = {
            (int(ref.template_id[i]), int(ref.x[i]), int(ref.y[i]),
             round(float(ref.similarity[i]), 3))
            for i in range(len(ref))
        }
        assert got == want, f"frame {b}: {got} != {want}"


def test_sharded_pooled_mode_equals_positions_mode(rng, mesh8):
    """prune_mode='pooled' (the production batch-shared-pool mode) must
    produce the same valid matches as the per-frame-cap mode, shard-local
    pooling and all."""
    import sys

    from jax.sharding import NamedSharding, PartitionSpec as P

    sys.path.insert(0, "tests")
    from test_match import make_object_patch, plant

    from linemod_pose_estimation.models.detector import Detector
    from linemod_pose_estimation.models.templates import DetectorParams

    patch, mask = make_object_patch(rng)
    src = plant((128, 128, 3), patch, (30, 50))
    src_mask = plant((128, 128), mask, (30, 50))
    det = Detector(DetectorParams(), engine="gather")
    assert det.add_template(src, src_mask, "obj") == 0
    bank = det.bank("obj")
    T0, T1 = det.params.t_pyramid
    Kc1 = bank.max_cell_extent(1)
    E0 = bank.extent(0)
    sb = make_sharded_bank(mesh8, bank.merged_features(1),
                           bank.merged_features(0), C=8, T1=T1, Kc1=Kc1)
    frames = np.stack([src, plant((128, 128, 3), patch, (38, 34))])
    rgbs = jax.device_put(jnp.asarray(frames), NamedSharding(mesh8, P("data")))
    depths = jax.device_put(jnp.zeros((2, 128, 128), jnp.float32),
                            NamedSharding(mesh8, P("data")))

    kw = dict(top_k=8, threshold=90.0, T0=T0, E0=E0)
    step_pos = make_sharded_detect_step(mesh8, T1, Kc1, prune=True,
                                        prune_mode="positions", **kw)
    step_pool = make_sharded_detect_step(mesh8, T1, Kc1, prune=True,
                                         prune_mode="pooled",
                                         pool_coarse=256, pool_fine=128,
                                         **kw)
    m_pos, met_pos = step_pos(rgbs, depths, sb)
    m_pool, met_pool = step_pool(rgbs, depths, sb)
    assert int(met_pool["prune_fallback_shards"]) == 0

    def vset(m, b):
        t, x, y, s, v = (np.asarray(a) for a in m)
        return {(int(t[b, i]), int(x[b, i]), int(y[b, i]),
                 round(float(s[b, i]), 4))
                for i in range(t.shape[1]) if v[b, i]}

    for b in range(2):
        assert vset(m_pool, b) == vset(m_pos, b) != set()
