"""The port's synthetic-scene data (data/formats.py, data/synthetic.py)
against the JAX package's: the file formats' round trips, each package
reading the other's files; the three parsers' `load_data` on dataset trees
built here (as tests/test_data.py builds them); and the CLI on a tiny CARLA
scene. Frames, depths, poses and flows are equal; the soft masks agree
within 1e-4 (the gather warp's f32 rounding, as in tests/test_torch_data.py),
the track ids and voxels exactly; with RAFT's flows (InteriorNet) the
flows and masks within 1e-4."""

from pathlib import Path

import numpy as np
import pytest
import torch
from test_data import _make_carla_tree

from tclight_torch.data import formats, synthetic
from tclight_torch.data.dataparsers import make_data_parser
from tclight_tpu.data import formats as jformats
from tclight_tpu.data import synthetic as jsynthetic

torch.set_num_threads(2)


@pytest.mark.parametrize("shape", [(6, 8), (6, 8, 3)])
def test_pfm_round_trips_between_packages(tmp_path, rng, shape):
    arr = rng.standard_normal(shape).astype(np.float32)
    formats.write_pfm(tmp_path / "a.pfm", arr, scale=2.0)
    jformats.write_pfm(tmp_path / "b.pfm", arr, scale=2.0)
    assert (tmp_path / "a.pfm").read_bytes() == (tmp_path / "b.pfm").read_bytes()
    back, scale = formats.read_pfm(tmp_path / "b.pfm")
    np.testing.assert_array_equal(back, arr)
    assert scale == 2.0
    with pytest.raises(ValueError):
        (tmp_path / "c.pfm").write_bytes(b"P6\n1 1\n")
        formats.read_pfm(tmp_path / "c.pfm")


def test_flo_and_float3_round_trips(tmp_path, rng):
    flow = rng.standard_normal((5, 7, 2)).astype(np.float32)
    formats.write_flo(tmp_path / "f.flo", flow)
    np.testing.assert_array_equal(jformats.read_flo(tmp_path / "f.flo"), flow)
    np.testing.assert_array_equal(formats.read_flo(tmp_path / "f.flo"), flow)
    (tmp_path / "bad.flo").write_bytes(np.float32(1.0).tobytes())
    with pytest.raises(ValueError):
        formats.read_flo(tmp_path / "bad.flo")
    blob = rng.standard_normal((3, 4, 2)).astype(np.float32)
    with open(tmp_path / "x.float3", "wb") as f:
        f.write(b"float\n3\n3\n4\n2\n")
        blob.transpose().tofile(f)  # the array's dims, its data fastest axis first
    np.testing.assert_array_equal(formats.read_float3(tmp_path / "x.float3"), blob)
    np.testing.assert_array_equal(jformats.read_float3(tmp_path / "x.float3"), blob)


def _assert_load_data_matches(ours, theirs, ids):
    out = ours.load_data(ids, device="cpu")
    ref = theirs.load_data(ids)
    for k in range(5):  # rgbs, depths, c2ws, future, past
        if ref[k] is None:
            assert out[k] is None
        else:
            np.testing.assert_array_equal(out[k], ref[k])
    np.testing.assert_allclose(out[5], ref[5], atol=1e-4)
    assert ours.n_unique == theirs.n_unique
    np.testing.assert_array_equal(ours.unq_inv, theirs.unq_inv)
    return out


@pytest.mark.parametrize("voxel_size", [None, 0.5])
def test_carla_parser_matches_jax(tmp_path, voxel_size):
    _make_carla_tree(tmp_path, n=4)
    cfg = {"data_dir": str(tmp_path), "height": 16, "width": 16, "voxel_size": voxel_size,
           "scene_type": "carla"}
    ours = make_data_parser(cfg)
    assert isinstance(ours, synthetic.CarlaDataParser) and ours.n_frames == 4
    out = _assert_load_data_matches(ours, jsynthetic.CarlaDataParser(cfg), [0, 1, 2, 3])
    assert out[0].shape == (4, 16, 16, 3) and out[3][0, 0, 0, 0] == 1.0
    assert ours.unq_inv.shape == (4 * 16 * 16,)


def _make_sceneflow_tree(root: Path, n=3, h=16, w=24):
    import cv2

    scene = "15mm_focallength/scene_backwards/fast"
    rng = np.random.default_rng(1)
    dirs = {k: root / k / scene / "left" for k in ("frames_cleanpass", "disparity")}
    dirs["future"] = root / "optical_flow" / scene / "into_future" / "left"
    dirs["past"] = root / "optical_flow" / scene / "into_past" / "left"
    for d in dirs.values():
        d.mkdir(parents=True)
    base = (rng.uniform(0.2, 0.8, (h, w, 3)) * 255).astype(np.uint8)
    lines = []
    for i in range(n):
        fid = 6 + i  # SceneFlow numbers frames from its own start
        cv2.imwrite(str(dirs["frames_cleanpass"] / f"{fid:04d}.png"),
                    cv2.cvtColor(np.roll(base, i, axis=1), cv2.COLOR_RGB2BGR))
        formats.write_pfm(dirs["disparity"] / f"{fid:04d}.pfm",
                          rng.uniform(20, 40, (h, w)).astype(np.float32))
        flow = np.zeros((h, w, 3), np.float32)
        flow[..., 0] = 1.0
        formats.write_pfm(dirs["future"] / f"OpticalFlowIntoFuture_{fid:04d}_L.pfm", flow)
        formats.write_pfm(dirs["past"] / f"OpticalFlowIntoPast_{fid:04d}_L.pfm", -flow)
        mat = " ".join(str(v) for v in [1, 0, 0, 0.1 * i, 0, 1, 0, 0, 0, 0, 1, 0.2 * i])
        lines += [f"Frame {fid}", f"L {mat}", f"R {mat}", ""]
    cam = root / "camera_data" / scene
    cam.mkdir(parents=True)
    (cam / "camera_data.txt").write_text("\n".join(lines))


@pytest.mark.parametrize("voxel_size", [None, 2.0])
def test_sceneflow_parser_matches_jax(tmp_path, voxel_size):
    _make_sceneflow_tree(tmp_path)
    cfg = {"data_dir": str(tmp_path), "voxel_size": voxel_size, "scene_type": "sceneflow"}
    ours = make_data_parser(cfg)
    assert isinstance(ours, synthetic.SceneFlowDataParser) and ours.n_frames == 3
    out = _assert_load_data_matches(ours, jsynthetic.SceneFlowDataParser(cfg), [0, 1, 2])
    assert out[1].shape == (3, 16, 24) and out[2].shape == (3, 4, 4)
    np.testing.assert_array_equal(
        synthetic.read_sceneflow_camdata(tmp_path / "camera_data" /
                                         "15mm_focallength/scene_backwards/fast" /
                                         "camera_data.txt")[2]["left"],
        ours.cam_info[2]["left"])


def _make_interiornet_tree(root: Path, n=3, h=32, w=48):
    import cv2

    rng = np.random.default_rng(2)
    (root / "cam0" / "data").mkdir(parents=True)
    (root / "depth0" / "data").mkdir(parents=True)
    base = cv2.GaussianBlur(rng.uniform(0.1, 0.9, (h, w, 3)).astype(np.float32), (0, 0), 1.5)
    for i in range(n):
        name = f"{1000 + 40 * i:019d}.png"
        cv2.imwrite(str(root / "cam0" / "data" / name),
                    cv2.cvtColor((np.roll(base, 2 * i, axis=1) * 255).astype(np.uint8),
                                 cv2.COLOR_RGB2BGR))
        cv2.imwrite(str(root / "depth0" / "data" / name),
                    rng.integers(1000, 4000, (h, w)).astype(np.uint16))
    (root / "intrinsics.txt").write_text("40 40 24 16")
    (root / "cam0.visim").write_text("# ts tx ty tz qw qx qy qz\n" + "".join(
        f"{i}, {0.1 * i}, 0.0, 0.0, 0.9238795, 0.0, 0.3826834, 0.0\n" for i in range(n)))


def test_interiornet_parser_matches_jax(tmp_path):
    """Farneback flows (the parser's default backend) with spatial voxels;
    then the same parsers on a tiny RAFT (JAX's weights carried across)."""
    import jax
    import jax.numpy as jnp

    from tclight_torch.models import bridge
    from tclight_torch.models.raft import RAFTConfig, RAFTFlowModel
    from tclight_tpu.models import raft as jraft

    _make_interiornet_tree(tmp_path)
    cfg = {"data_dir": str(tmp_path), "voxel_size": 0.2, "scene_type": "interiornet"}
    ours = make_data_parser(cfg)
    assert isinstance(ours, synthetic.InteriorNetDataParser) and ours.n_frames == 3
    out = _assert_load_data_matches(ours, jsynthetic.InteriorNetDataParser(cfg), [0, 1, 2])
    assert out[1].shape == (3, 32, 48) and out[2].shape == (3, 4, 4)

    a = jnp.zeros((1, 32, 48, 3), jnp.float32)
    params = jax.jit(lambda k, x: jraft.RAFT(jraft.RAFTConfig.tiny()).init(k, x, x, iters=1))(
        jax.random.PRNGKey(0), a)
    ours = make_data_parser(cfg, flow_backend="raft", raft=RAFTFlowModel(
        bridge.raft_state_dict(params), RAFTConfig.tiny(), device="cpu"))
    theirs = jsynthetic.make_parser("interiornet", cfg, flow_backend="raft",
                                    raft=jraft.RAFTFlowModel(params, jraft.RAFTConfig.tiny()))
    out, ref = ours.load_data([0, 1, 2], device="cpu"), theirs.load_data([0, 1, 2])
    for k in (3, 4):  # RAFT flows: f32 through 4 refinement steps
        np.testing.assert_allclose(out[k], ref[k], atol=1e-4)
    np.testing.assert_allclose(out[5], ref[5], atol=1e-4)


def test_cli_runs_a_tiny_carla_scene_on_cpu(tmp_path, monkeypatch):
    """`tclight_torch.run` on data.scene_type carla: the parser's ground-truth
    flows feed the post-optimization (2 + 2 epochs); an mp4 of every frame
    and finite loss histories."""
    import cv2

    from tclight_torch.run import main

    monkeypatch.chdir(Path(__file__).resolve().parent.parent)
    monkeypatch.setenv("TCLIGHT_TINY", "1")
    scene = tmp_path / "carla"
    scene.mkdir()
    _make_carla_tree(scene, n=4, h=32, w=32)
    args = ["--config", "configs/tclight_default.yaml", "-i", str(scene / "rgb"),
            "-p", "warm sunset light", "data.scene_type=carla", f"data.data_dir={scene}",
            "data.height=32", "data.width=32", "generation.n_timesteps=2",
            f"work_dir={tmp_path / 'wd'}", "generation.save_frame=false",
            "post_opt.epochs_exposure=2", "post_opt.epochs=2", "post_opt.batch_size=4",
            "post_opt.ms_ssim_levels=2"]
    assert main(args, device="cpu") == 0
    mp4 = next((tmp_path / "wd").rglob("output.mp4"))
    cap = cv2.VideoCapture(str(mp4))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 4
    for name in ("loss_exposure", "loss_unique_tensor"):
        hist = np.load(mp4.parent / f"{name}.npy")
        assert hist.shape == (2,) and np.isfinite(hist).all()  # 2 epochs of one batch
