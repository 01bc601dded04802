"""End-to-end cascade tests: render -> train -> detect -> 6D pose."""

import jax.numpy as jnp
import numpy as np
import pytest

from linemod_pose_estimation.models import cascade as CC
from linemod_pose_estimation.models.detector import Detector
from linemod_pose_estimation.models.pipeline import DetectionPipeline
from linemod_pose_estimation.models.renderer import Renderer
from linemod_pose_estimation.models.templates import (
    DetectorParams,
    RendererGlobals,
    TemplateBank,
    TemplateMetadata,
)
from linemod_pose_estimation.ops.match import Matches
from linemod_pose_estimation.utils import geometry as geo
from linemod_pose_estimation.utils import pointcloud as pcu

from conftest import BANK_PARAMS as BANK, BOX_STL as STL

W, H = 160, 120


def make_matches(entries, cap=64):
    """entries: list of (x, y, tid, sim)."""
    n = len(entries)
    x = np.zeros(cap, np.int32)
    y = np.zeros(cap, np.int32)
    t = np.zeros(cap, np.int32)
    s = np.zeros(cap, np.float32)
    v = np.zeros(cap, bool)
    for i, (xi, yi, ti, si) in enumerate(entries):
        x[i], y[i], t[i], s[i], v[i] = xi, yi, ti, si, True
    return Matches(jnp.asarray(t), jnp.asarray(x), jnp.asarray(y), jnp.asarray(s), jnp.asarray(v))


def test_cluster_matches_groups_and_filters():
    # Two spatial groups; group A has 4 matches, group B has 2 (filtered at
    # thresh=2 only if <=2 -> B dropped).
    ents = [(10, 10, 0, 95), (12, 11, 0, 93), (15, 14, 0, 91), (18, 12, 0, 97),
            (100, 100, 0, 99), (101, 101, 0, 98)]
    m = make_matches(ents)
    od = jnp.full((4,), 0.55, jnp.float32)
    rects = jnp.tile(jnp.array([[0, 0, 30, 40]], jnp.int32), (4, 1))
    cs = CC.cluster_matches(m, od, rects, 0.5, 0.1, 20, 2, 8, 16)
    nvalid = int(np.sum(np.asarray(cs.valid)))
    assert nvalid == 1
    i = int(np.argmax(np.asarray(cs.valid)))
    assert int(cs.count[i]) == 4
    np.testing.assert_allclose(float(cs.score[i]), (95 + 93 + 91 + 97) / 4, atol=1e-4)
    # Averaged bbox: x = floor(mean(10,12,15,18)) = 13, w = 30.
    np.testing.assert_allclose(np.asarray(cs.bbox[i]), [13, 11, 30, 40])
    # Member indices map back to the original matches.
    mi = np.asarray(cs.member_idx[i])[np.asarray(cs.member_valid[i])]
    assert set(np.asarray(m.x)[mi].tolist()) == {10, 12, 15, 18}


def test_cluster_filter_threshold_semantics():
    # Exactly thresh members -> dropped (reference erases size() <= thresh).
    ents = [(10, 10, 0, 95), (12, 11, 0, 93)]
    m = make_matches(ents)
    od = jnp.full((1,), 0.55, jnp.float32)
    rects = jnp.array([[0, 0, 10, 10]], jnp.int32)
    cs = CC.cluster_matches(m, od, rects, 0.5, 0.1, 20, 2, 8, 16)
    assert int(np.sum(np.asarray(cs.valid))) == 0
    cs2 = CC.cluster_matches(m, od, rects, 0.5, 0.1, 20, 1, 8, 16)
    assert int(np.sum(np.asarray(cs2.valid))) == 1


def test_depth_bins_separate_clusters():
    # Same image cell, different template depths -> separate vote cells.
    ents = [(10, 10, 0, 95), (11, 11, 0, 93), (10, 11, 0, 94),
            (12, 10, 1, 90), (11, 12, 1, 92), (10, 12, 1, 91)]
    m = make_matches(ents)
    od = jnp.array([0.55, 0.95], jnp.float32)
    rects = jnp.tile(jnp.array([[0, 0, 10, 10]], jnp.int32), (2, 1))
    cs = CC.cluster_matches(m, od, rects, 0.5, 0.1, 20, 2, 8, 16)
    assert int(np.sum(np.asarray(cs.valid))) == 2


def test_nms_iou_suppresses_overlaps():
    score = jnp.array([90.0, 95.0, 80.0, -1.0])
    bbox = jnp.array(
        [[10, 10, 40, 40], [12, 12, 40, 40], [200, 200, 40, 40], [0, 0, 0, 0]],
        jnp.float32,
    )
    cs = CC.ClusterSet(
        score=score,
        count=jnp.array([3, 3, 3, 0]),
        bbox=bbox,
        valid=jnp.array([True, True, True, False]),
        member_idx=jnp.zeros((4, 4), jnp.int32),
        member_valid=jnp.zeros((4, 4), bool),
    )
    keep = np.asarray(CC.nms_iou(cs, 0.4))
    assert keep.tolist() == [False, True, True, False]  # 1 beats 0; 2 disjoint


@pytest.fixture(scope="module")
def pipeline():
    meta_full, glob = TemplateBank.read_params_yaml(BANK)
    # Small render geometry for CPU tests.
    glob.width, glob.height = W, H
    glob.focal_length_x /= 4
    glob.focal_length_y /= 4
    r = Renderer(STL, W, H, glob.focal_length_x, glob.focal_length_y)
    # Train on a handful of shipped poses (spread over the bank).
    ids = [40, 41, 42, 700, 1400]
    det = Detector(DetectorParams())
    kept = []
    for i in ids:
        out = r.render(meta_full.R[i], meta_full.T[i])
        tid = det.add_template(np.asarray(out.rgb), np.asarray(out.mask), "boxNew")
        if tid >= 0:
            kept.append(i)
    assert len(kept) >= 3
    meta = TemplateMetadata(
        R=meta_full.R[kept],
        T=meta_full.T[kept],
        K=meta_full.K[kept],
        D=meta_full.D[kept],
        Ori_dist=meta_full.Ori_dist[kept],
        Rect=meta_full.Rect[kept],
    )
    params = CC.CascadeParams(
        canonicalize="none",
        max_clusters=2,
        model_cap=512,
        scene_cap=512,
        icp_max_iter=40,
        cluster_filter_thresh=0,
    )
    pipe = DetectionPipeline(det, meta, glob, STL, params, render_size=(W, H))
    return pipe, r, meta, kept


def test_full_cascade_recovers_pose(pipeline):
    pipe, r, meta, kept = pipeline
    # Scene = training view 0 exactly; cloud from its rendered depth.
    out = r.render(meta.R[0], meta.T[0])
    rgb = np.asarray(out.rgb)
    cloud = np.asarray(pcu.depth_to_cloud(out.depth_mm / 1000.0, r.K))
    dets = pipe.detect(rgb, cloud, threshold=85.0)
    assert len(dets) >= 1
    d = dets[0]
    R_gt = meta.R[0]
    t_gt = R_gt @ meta.T[0]
    ang = float(geo.rotation_geodesic_deg(jnp.asarray(R_gt), jnp.asarray(d.pose[:3, :3])))
    terr = np.linalg.norm(d.pose[:3, 3] - t_gt)
    assert ang < 5.0, f"rotation error {ang} deg"
    assert terr < 0.01, f"translation error {terr} m"
    assert d.score >= 85.0


def test_cascade_empty_scene(pipeline):
    pipe, r, meta, kept = pipeline
    rgb = np.zeros((H, W, 3), np.uint8)
    cloud = np.full((H, W, 3), np.nan, np.float32)
    dets = pipe.detect(rgb, cloud, threshold=85.0)
    assert dets == []


def test_detect_return_stages_and_overlay(pipeline):
    """C23: detect(return_stages=True) exposes every cascade stage —
    matches, vote cells, NMS survivors, pre/post-ICP poses — and
    draw_response paints match features (service.cpp:723-748 analog)."""
    pipe, r, meta, kept = pipeline
    out = r.render(meta.R[0], meta.T[0])
    rgb = np.asarray(out.rgb)
    cloud = np.asarray(pcu.depth_to_cloud(out.depth_mm / 1000.0, r.K))
    dets, stages = pipe.detect(rgb, cloud, threshold=85.0, return_stages=True)
    assert len(dets) >= 1
    # Raw matches feed the cascade.
    assert np.asarray(stages.matches.valid).any()
    # Vote cells grouped + filtered; at least one cluster alive.
    alive = np.asarray(stages.clusters.valid)
    assert alive.any()
    assert stages.nms_keep.shape == alive.shape
    assert (np.asarray(stages.clusters.count)[alive] >= 1).all()
    # Pre/post-ICP poses both present; rough pose is a valid rigid transform.
    i = int(np.nonzero(np.asarray(stages.poses.valid))[0][0])
    rough = np.asarray(stages.poses.rough_pose[i])
    refined = np.asarray(stages.poses.pose[i])
    for P4 in (rough, refined):
        assert P4.shape == (4, 4)
        np.testing.assert_allclose(P4[:3, :3] @ P4[:3, :3].T, np.eye(3), atol=1e-4)
    assert dets[0].rough_pose is not None
    # Overlay: some pixels change where features land.
    img = pipe.draw_response(rgb, stages.matches)
    assert img.shape == rgb.shape
    assert (img != rgb).any()


def test_cluster_member_cap_overflow_keeps_best():
    """Capacity probe (round-1 weak spot): a vote cell with more members
    than members_cap must keep the HIGHEST-similarity members (matches
    arrive in descending-similarity order and the cell argsort is stable),
    while score/count still reflect ALL members."""
    import jax.numpy as jnp

    from linemod_pose_estimation.models.cascade import cluster_matches
    from linemod_pose_estimation.ops.match import Matches

    K, cap = 32, 8
    # All matches in one vote cell (same position bucket, same depth bin),
    # similarities descending 99, 98, ...
    sims = jnp.arange(99.0, 99.0 - K, -1.0)
    m = Matches(
        template_id=jnp.zeros((K,), jnp.int32),
        x=jnp.full((K,), 40, jnp.int32),
        y=jnp.full((K,), 40, jnp.int32),
        similarity=sims,
        valid=jnp.ones((K,), bool),
    )
    ori = jnp.array([0.7])
    rects = jnp.array([[0, 0, 50, 60]], jnp.int32)
    cs = cluster_matches(m, ori, rects, 0.5, 0.1, step=20, filter_thresh=2,
                         max_cells=4, members_cap=cap)
    assert bool(cs.valid[0])
    assert int(cs.count[0]) == K  # full population counted
    assert float(cs.score[0]) == float(jnp.mean(sims))  # scored over ALL
    mi = cs.member_idx[0][cs.member_valid[0]]
    kept = sorted(float(s) for s in sims[mi])
    # the cap slots hold the top-`cap` similarities
    assert kept == sorted(float(s) for s in sims[:cap])
    assert int(jnp.sum(cs.member_valid[0])) == cap


@pytest.mark.slow
@pytest.mark.slow
def test_renderer_parity_pinned_vs_shipped_bank():
    """Pin the renderer's deviation against the shipped 2652-template bank
    (E2 parity): bbox within 4 px and center depth within 2 mm of the
    reference's recorded Rect / (Ori_dist - D) for spread template ids at
    full 640x480 resolution.  Guards regressions of the current deviation
    (round-1 weak #7)."""
    meta, glob = TemplateBank.read_params_yaml(BANK)
    r = Renderer(STL, glob.width, glob.height,
                 glob.focal_length_x, glob.focal_length_y)
    for tid in (0, 100, 2651):
        out = r.render(meta.R[tid], meta.T[tid])
        got = np.asarray(out.rect)
        want = meta.Rect[tid]
        assert np.abs(got - want).max() <= 4, (tid, got, want)
        # Center-pixel depth vs Ori_dist - D (renderer.cpp:284-285).
        cx, cy = got[0] + got[2] // 2, got[1] + got[3] // 2
        d_mm = float(out.depth_mm[cy, cx])
        want_mm = (meta.Ori_dist[tid] - meta.D[tid]) * 1000.0
        assert abs(d_mm - want_mm) <= 2.0, (tid, d_mm, want_mm)


@pytest.mark.slow
@pytest.mark.slow
def test_full_cascade_rgbd_modality(pipeline):
    """BASELINE config 'depth-normal modality + ICP': train a dual-modality
    (ColorGradient + DepthNormal) bank and run the full cascade with the
    depth image feeding the normal responses (carmine's 2-modality match,
    linemod_carmine_detect.cpp:330)."""
    _, r, meta, kept = pipeline
    det = Detector(DetectorParams(use_depth_normal=True))
    ids = []
    for i in range(len(kept)):
        out = r.render(meta.R[i], meta.T[i])
        tid = det.add_template(
            np.asarray(out.rgb), np.asarray(out.mask), "boxNew",
            depth_mm=np.asarray(out.depth_mm),
        )
        if tid >= 0:
            ids.append(i)
    assert len(ids) >= 2
    meta2 = TemplateMetadata(
        R=meta.R[ids], T=meta.T[ids], K=meta.K[ids], D=meta.D[ids],
        Ori_dist=meta.Ori_dist[ids], Rect=meta.Rect[ids],
    )
    glob2 = TemplateBank.read_params_yaml(BANK)[1]
    glob2.width, glob2.height = W, H
    glob2.focal_length_x /= 4
    glob2.focal_length_y /= 4
    params = CC.CascadeParams(
        canonicalize="none", max_clusters=2, model_cap=512, scene_cap=512,
        icp_max_iter=40, cluster_filter_thresh=0,
    )
    pipe = DetectionPipeline(det, meta2, glob2, STL, params, render_size=(W, H))

    out = r.render(meta2.R[0], meta2.T[0])
    rgb = np.asarray(out.rgb)
    depth_mm = np.asarray(out.depth_mm)
    cloud = np.asarray(pcu.depth_to_cloud(depth_mm / 1000.0, r.K))
    dets = pipe.detect(rgb, cloud, threshold=85.0, depth_mm=depth_mm)
    assert len(dets) >= 1
    d = dets[0]
    R_gt = meta2.R[0]
    t_gt = R_gt @ meta2.T[0]
    ang = float(geo.rotation_geodesic_deg(jnp.asarray(R_gt), jnp.asarray(d.pose[:3, :3])))
    terr = np.linalg.norm(d.pose[:3, 3] - t_gt)
    assert ang < 5.0, f"rotation error {ang} deg"
    assert terr < 0.01, f"translation error {terr} m"


@pytest.mark.slow
@pytest.mark.slow
def test_full_cascade_nonlinear_icp_variant(pipeline):
    """icp_variant='nonlinear' (the icpNonLinearPoseRefine 3-pass LM
    schedule) recovers the pose through the full cascade too."""
    _, r, meta, kept = pipeline
    det = Detector(DetectorParams())
    ids = []
    for i in range(len(kept)):
        out = r.render(meta.R[i], meta.T[i])
        if det.add_template(np.asarray(out.rgb), np.asarray(out.mask), "boxNew") >= 0:
            ids.append(i)
    meta2 = TemplateMetadata(
        R=meta.R[ids], T=meta.T[ids], K=meta.K[ids], D=meta.D[ids],
        Ori_dist=meta.Ori_dist[ids], Rect=meta.Rect[ids],
    )
    glob2 = TemplateBank.read_params_yaml(BANK)[1]
    glob2.width, glob2.height = W, H
    glob2.focal_length_x /= 4
    glob2.focal_length_y /= 4
    params = CC.CascadeParams(
        canonicalize="none", max_clusters=2, model_cap=512, scene_cap=512,
        cluster_filter_thresh=0, icp_variant="nonlinear",
    )
    pipe = DetectionPipeline(det, meta2, glob2, STL, params, render_size=(W, H))
    out = r.render(meta2.R[0], meta2.T[0])
    cloud = np.asarray(pcu.depth_to_cloud(np.asarray(out.depth_mm) / 1000.0, r.K))
    dets = pipe.detect(np.asarray(out.rgb), cloud, threshold=85.0)
    assert len(dets) >= 1
    d = dets[0]
    R_gt = meta2.R[0]
    t_gt = R_gt @ meta2.T[0]
    ang = float(geo.rotation_geodesic_deg(jnp.asarray(R_gt), jnp.asarray(d.pose[:3, :3])))
    assert ang < 5.0
    # LM's strict final pass (corr 0.005) tolerates a slightly looser
    # landing on this low-res synthetic than the Kabsch two-stage path.
    assert np.linalg.norm(d.pose[:3, 3] - t_gt) < 0.015


@pytest.mark.slow
@pytest.mark.slow
def test_full_cascade_local_descriptor_strategy(pipeline):
    """position_strategy='local_descriptor' (SHOT + Hough full-pose path,
    getPoseByLocalDescriptor) through the whole cascade."""
    _, r, meta, kept = pipeline
    det = Detector(DetectorParams())
    ids = []
    for i in range(len(kept)):
        out = r.render(meta.R[i], meta.T[i])
        if det.add_template(np.asarray(out.rgb), np.asarray(out.mask), "boxNew") >= 0:
            ids.append(i)
    meta2 = TemplateMetadata(
        R=meta.R[ids], T=meta.T[ids], K=meta.K[ids], D=meta.D[ids],
        Ori_dist=meta.Ori_dist[ids], Rect=meta.Rect[ids],
    )
    glob2 = TemplateBank.read_params_yaml(BANK)[1]
    glob2.width, glob2.height = W, H
    glob2.focal_length_x /= 4
    glob2.focal_length_y /= 4
    params = CC.CascadeParams(
        canonicalize="none", max_clusters=2, model_cap=512, scene_cap=512,
        icp_max_iter=40, cluster_filter_thresh=0,
        position_strategy="local_descriptor",
    )
    pipe = DetectionPipeline(det, meta2, glob2, STL, params, render_size=(W, H))
    out = r.render(meta2.R[0], meta2.T[0])
    cloud = np.asarray(pcu.depth_to_cloud(np.asarray(out.depth_mm) / 1000.0, r.K))
    dets = pipe.detect(np.asarray(out.rgb), cloud, threshold=85.0)
    assert len(dets) >= 1
    d = dets[0]
    R_gt = meta2.R[0]
    t_gt = R_gt @ meta2.T[0]
    ang = float(geo.rotation_geodesic_deg(jnp.asarray(R_gt), jnp.asarray(d.pose[:3, :3])))
    assert ang < 8.0, ang
    assert np.linalg.norm(d.pose[:3, 3] - t_gt) < 0.015


def test_nms_rects_ranks_by_key():
    """nms_rects keeps the higher-KEY rect among overlaps (pose-aware NMS:
    verification outranks match score)."""
    rects = jnp.asarray(np.array([
        [10, 10, 50, 50],   # overlaps with next
        [12, 12, 50, 50],
        [200, 200, 40, 40],  # disjoint
    ], np.int32))
    key = jnp.asarray(np.array([0.2, 0.9, 0.1], np.float32))  # second wins
    valid = jnp.asarray(np.array([True, True, True]))
    keep = np.asarray(CC.nms_rects(rects, key, valid, 0.4))
    assert keep.tolist() == [False, True, True]


def test_full_cascade_point_to_plane_and_hypotheses(pipeline):
    """icp_variant='point_to_plane' with orientation_hypotheses=2 and
    pose-aware NMS recovers the pose through the full cascade (the
    accuracy configuration)."""
    _, r, meta, kept = pipeline
    det = Detector(DetectorParams())
    ids = []
    for i in range(len(kept)):
        out = r.render(meta.R[i], meta.T[i])
        if det.add_template(np.asarray(out.rgb), np.asarray(out.mask), "boxNew") >= 0:
            ids.append(i)
    meta2 = TemplateMetadata(
        R=meta.R[ids], T=meta.T[ids], K=meta.K[ids], D=meta.D[ids],
        Ori_dist=meta.Ori_dist[ids], Rect=meta.Rect[ids],
    )
    glob2 = TemplateBank.read_params_yaml(BANK)[1]
    glob2.width, glob2.height = W, H
    glob2.focal_length_x /= 4
    glob2.focal_length_y /= 4
    params = CC.CascadeParams(
        canonicalize="none", max_clusters=2, model_cap=512, scene_cap=512,
        cluster_filter_thresh=0, icp_variant="point_to_plane",
        orientation_hypotheses=2, nms_after_pose=True,
    )
    pipe = DetectionPipeline(det, meta2, glob2, STL, params, render_size=(W, H))
    out = r.render(meta2.R[0], meta2.T[0])
    cloud = np.asarray(pcu.depth_to_cloud(np.asarray(out.depth_mm) / 1000.0, r.K))
    dets = pipe.detect(np.asarray(out.rgb), cloud, threshold=85.0)
    assert len(dets) >= 1
    d = dets[0]
    R_gt = meta2.R[0]
    t_gt = R_gt @ meta2.T[0]
    ang = float(geo.rotation_geodesic_deg(jnp.asarray(R_gt), jnp.asarray(d.pose[:3, :3])))
    assert ang < 5.0
    assert np.linalg.norm(d.pose[:3, 3] - t_gt) < 0.015


def test_inplane_sweep_recovers_face_on_rotation():
    """A single visible plane + a ~3 deg in-plane rotation offset — the
    configuration point-to-plane ICP is blind to (the ACCURACY deg_err max
    tail) — must be repaired by the rank-deficient in-plane sweep."""
    # Scene: a 10 x 6 cm face-on rectangle at z = 0.5, normals all +z.
    xs, ys = np.meshgrid(np.linspace(-0.05, 0.05, 24),
                         np.linspace(-0.03, 0.03, 16))
    scene = np.stack([xs.ravel(), ys.ravel(),
                      np.full(xs.size, 0.5)], axis=1).astype(np.float32)
    pad = 512 - scene.shape[0]
    scene_pts = np.concatenate([scene, np.zeros((pad, 3), np.float32)])
    scene_valid = np.arange(512) < scene.shape[0]
    scene_n = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (512, 1))

    # Model: the same rectangle rotated +3 deg about z through its centroid.
    th = np.deg2rad(3.0)
    Rz = np.array([[np.cos(th), -np.sin(th), 0.0],
                   [np.sin(th), np.cos(th), 0.0],
                   [0.0, 0.0, 1.0]], np.float32)
    c = scene.mean(axis=0)
    model = (scene - c) @ Rz.T + c
    model_pts = np.concatenate([model, np.zeros((pad, 3), np.float32)])
    model_valid = scene_valid.copy()

    T_fix, applied = CC.inplane_sweep_fix(
        jnp.asarray(model_pts), jnp.asarray(model_valid),
        jnp.asarray(scene_pts), jnp.asarray(scene_n),
        jnp.asarray(scene_valid), jnp.asarray(True),
        sweep_deg=6.0, dominance=0.95,
    )
    assert bool(applied)
    ang = float(geo.rotation_geodesic_deg(
        jnp.asarray(Rz.T), T_fix[:3, :3]))
    assert ang < 0.5, f"sweep left {ang} deg of the 3 deg offset"
    fixed = np.asarray(model_pts @ np.asarray(T_fix[:3, :3]).T
                       + np.asarray(T_fix[:3, 3]))
    err = np.abs(fixed[scene_valid] - scene).max()
    assert err < 1.5e-3

    # Already aligned -> the improvement gate keeps the identity.
    T_id, applied0 = CC.inplane_sweep_fix(
        jnp.asarray(scene_pts), jnp.asarray(model_valid),
        jnp.asarray(scene_pts), jnp.asarray(scene_n),
        jnp.asarray(scene_valid), jnp.asarray(True),
        sweep_deg=6.0, dominance=0.95,
    )
    assert not bool(applied0)
    np.testing.assert_allclose(np.asarray(T_id), np.eye(4), atol=1e-5)

    # Two visible planes -> not rank-deficient -> no fix even if offset.
    scene_n2 = scene_n.copy()
    scene_n2[:192] = [1.0, 0.0, 0.0]
    _, applied2 = CC.inplane_sweep_fix(
        jnp.asarray(model_pts), jnp.asarray(model_valid),
        jnp.asarray(scene_pts), jnp.asarray(scene_n2),
        jnp.asarray(scene_valid), jnp.asarray(True),
        sweep_deg=6.0, dominance=0.95,
    )
    assert not bool(applied2)


@pytest.mark.parametrize("stem,true_deg,min_axis_align", [
    # view 45, face-on single plane: 3.02 deg in-plane, the NN-score
    # sweep measured FLAT to 0.02% across +-5 deg so it never applied.
    ("sweep_view45_clouds", 3.02, 0.999),
    # view 0, TWO faces visible (mode-aligned fraction 0.84): ICP's
    # in-plane mode is weakly constrained and left 1.35 deg; the mode
    # normal (mean-shift) aligns 0.996 with the true error axis.
    ("sweep_view00_clouds", 1.35, 0.99),
])
def test_inplane_sweep_real_failing_views(stem, true_deg, min_axis_align):
    """Regression anchors on the REAL clouds of the two ACCURACY
    deg_err tail views (captured via LPE_DUMP_SWEEP): the
    rectangle-orientation estimator must apply a correction within
    0.5 deg of the truth, about the mode scene normal."""
    import os

    z = np.load(os.path.join(os.path.dirname(__file__), "..", "data",
                             f"{stem}.npz"))
    T_fix, applied = CC.inplane_sweep_fix(
        jnp.asarray(z["model"]), jnp.asarray(z["mvalid"]),
        jnp.asarray(z["scene"]), jnp.asarray(z["snorm"]),
        jnp.asarray(z["svalid"]), jnp.asarray(True),
        sweep_deg=6.0, dominance=0.7,
    )
    assert bool(applied)
    R = np.asarray(T_fix[:3, :3])
    ang = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))
    assert abs(ang - true_deg) < 0.5, f"correction {ang} deg vs {true_deg}"
    # axis must be the mode scene normal (in-plane repair only); the
    # plain mean normal is a good-enough proxy for the alignment check
    # on the single-face view, so mean-shift it the same way here.
    ax = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    ax /= max(np.linalg.norm(ax), 1e-12)
    sn = np.asarray(z["snorm"])[np.asarray(z["svalid"]).astype(bool)]
    n = sn.mean(0)
    n /= np.linalg.norm(n)
    for _ in range(4):
        w = np.abs(sn @ n) > 0.9
        if not w.any():
            break
        n2 = (sn * np.sign(sn @ n)[:, None])[w].mean(0)
        n = n2 / np.linalg.norm(n2)
    assert abs(ax @ n) > min_axis_align
