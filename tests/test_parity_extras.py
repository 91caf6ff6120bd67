"""Tests for parity-completing extras: projection match, camera hooks,
occupancy save/load, match visualization."""

import jax
import jax.numpy as jnp
import numpy as np

from rgbdslam.config import ExtractorConfig
from rgbdslam.frontend.frame import build_frame_features
from rgbdslam.frontend.matcher import match_frames, projection_match
from rgbdslam.geometry import camera as cam_mod
from rgbdslam.geometry.camera import Camera, camera_from_dict
from rgbdslam.io.synthetic import SyntheticDataset

CAM = Camera(160.0, 160.0, 127.5, 95.5, width=256, height=192)
CFG = ExtractorConfig(num_features=512, num_levels=3, cell_size=8,
                      fast_threshold=15.0)


def test_projection_match_on_synthetic_pair():
    ds = SyntheticDataset(n_frames=40, cam=CAM, trajectory="sweep")
    _, g0, d0 = ds.grab(0)
    _, g1, d1 = ds.grab(1)
    f0 = build_frame_features(CAM, g0, d0, CFG)
    f1 = build_frame_features(CAM, g1, d1, CFG)
    T21 = jnp.asarray(
        (np.linalg.inv(ds.poses_twc[1]) @ ds.poses_twc[0]).astype(np.float32)
    )
    m = projection_match(f0, f1, T21, CAM)
    n = int(m.valid.sum())
    assert n > 50, n
    # matched pairs geometrically consistent
    p1 = np.asarray(f0.xyz)[np.asarray(m.valid)]
    p2 = np.asarray(f1.xyz)[np.asarray(m.idx2)][np.asarray(m.valid)]
    pred = p1 @ np.asarray(T21)[:3, :3].T + np.asarray(T21)[:3, 3]
    err = np.linalg.norm(pred - p2, axis=-1)
    assert np.median(err) < 0.05

    # projection-guided matching should find at least as many as brute force
    # given the correct prior (it searches a narrow window)
    mb = match_frames(f0, f1)
    assert n >= 0.5 * int(mb.num_matches)


def test_projection_match_wrong_prior_yields_few():
    ds = SyntheticDataset(n_frames=40, cam=CAM, trajectory="sweep")
    _, g0, d0 = ds.grab(0)
    _, g1, d1 = ds.grab(1)
    f0 = build_frame_features(CAM, g0, d0, CFG)
    f1 = build_frame_features(CAM, g1, d1, CFG)
    T_wrong = jnp.asarray(np.diag([1.0, 1.0, 1.0, 1.0]).astype(np.float32))
    T_wrong = T_wrong.at[0, 3].set(1.5)  # 1.5 m lateral error
    T_right = jnp.asarray(
        (np.linalg.inv(ds.poses_twc[1]) @ ds.poses_twc[0]).astype(np.float32)
    )
    m_right = projection_match(f0, f1, T_right, CAM)
    m_wrong = projection_match(f0, f1, T_wrong, CAM)
    # the periodic synthetic texture has lookalike blocks, so some descriptor
    # matches survive a wrong prior — but fewer, and geometrically wrong
    assert int(m_wrong.valid.sum()) < 0.7 * int(m_right.valid.sum())
    vr = np.asarray(m_wrong.valid)
    p1 = np.asarray(f0.xyz)[vr]
    p2 = np.asarray(f1.xyz)[np.asarray(m_wrong.idx2)][vr]
    pred = p1 @ np.asarray(T_right)[:3, :3].T + np.asarray(T_right)[:3, 3]
    err = np.linalg.norm(pred - p2, axis=-1)
    assert np.median(err) > 0.2  # survivors are aliases, not true matches


def test_random_camera_hooks():
    key = jax.random.PRNGKey(0)
    uv = cam_mod.random_keypoints(CAM, key, 64)
    assert np.asarray(cam_mod.in_bounds(CAM, uv)).all()
    pts = cam_mod.random_visible_points(CAM, key, 64)
    proj = np.asarray(cam_mod.project(CAM, pts))
    assert (proj[:, 0] >= 0).all() and (proj[:, 0] <= CAM.width - 1).all()
    assert (np.asarray(pts)[:, 2] >= 0.5).all()


def test_camera_from_dict_and_file(tmp_path):
    import json

    d = {"fx": 500.0, "fy": 501.0, "cx": 320.0, "cy": 240.0, "k1": 0.1,
         "depth_factor": 1000.0, "width": 640, "height": 480}
    cam = camera_from_dict(d)
    assert cam.fx == 500.0 and cam.k1 == 0.1 and cam.depth_factor == 1000.0
    p = tmp_path / "cam.json"
    p.write_text(json.dumps(d))
    cam2 = cam_mod.load_camera(str(p))
    assert cam2 == cam


def test_occupancy_save_load(tmp_path):
    from rgbdslam.mapping.occupancy import load_grid, make_grid, save_grid

    g = make_grid([-1, -1, -1], [1, 1, 1], resolution=0.25)
    g = g._replace(log_odds=g.log_odds.at[2, 3, 4].set(1.5))
    p = str(tmp_path / "grid.npz")
    save_grid(p, g)
    g2 = load_grid(p)
    assert float(g2.log_odds[2, 3, 4]) == 1.5
    assert g2.resolution == 0.25


def test_draw_matches():
    from rgbdslam.viz.export import draw_matches

    g1 = np.full((40, 60), 50.0)
    g2 = np.full((40, 60), 100.0)
    uv1 = np.array([[10.0, 10.0], [20.0, 30.0]])
    uv2 = np.array([[15.0, 12.0], [25.0, 28.0]])
    img = draw_matches(g1, uv1, g2, uv2, np.array([0, 1]), np.array([True, True]))
    assert img.shape == (40, 120, 3)
    assert (img[:, :, 1] == 220).any()  # green lines drawn
