"""The port's example workflows (`mladversarialobjectdetection_torch/
examples/`) on the CPU, at lite0@64.

`synthetic_scene_batch` is held bit-equal to the JAX example's. The stages
of the production soak and both north-star loops run on a pool of 64 px
rectangle scenes with a random victim (score threshold .0099 where the
defender and the gate need detections), and the tests hold their
bookkeeping: the detection gate and its FAILED record, the artifacts' names
and contents (the antipatch read back by JAX's `load_pytree`), the plateau's
lr after a flat validation loss, the best artifact, the `--max-hours` cap,
the `--initial-patch` restart, the frontier's frozen scale and its 4 EOT
draws per val batch, and that each record's keys include those of the TPU
records in `docs/` (SOAK_r03_1k, NORTHSTAR_phase1, FRONTIER,
VICTIM_CONFIDENCE), and the precision frontier's two arms on one victim.
Each entry point needs a card unless asked for the CPU.
"""
import importlib.util
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mladversarialobjectdetection_tpu.ckpt import io as jio
from mladversarialobjectdetection_torch import config as pconfig
from mladversarialobjectdetection_torch.attack import artifacts
from mladversarialobjectdetection_torch.attack.attacker import PatchAttacker
from mladversarialobjectdetection_torch.attack.train import get_victim
from mladversarialobjectdetection_torch.ckpt import bridge
from mladversarialobjectdetection_torch.examples import end_to_end_attack as e2e
from mladversarialobjectdetection_torch.examples import northstar_soak as ns
from mladversarialobjectdetection_torch.examples import production_soak as ps

REPO = Path(__file__).resolve().parents[1]
TINY = {"image_size": 64, "fpn_num_filters": 16, "fpn_cell_repeats": 1,
        "box_class_repeats": 1, "max_boxes_per_image": 4,
        "nms_configs": {"score_thresh": 0.0099, "pre_nms_topk": 64,
                        "max_output_size": 16}}
BATCH = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread for this file's tests: the tier-1 run
    shares the CPU among six workers, where torch's default of a thread per
    core oversubscribes it and the training steps slow down many-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TinyPool:
    """`ScenePool.sample`'s interface over 64 px rectangle scenes (the
    640 px person scenes do not fit a 64 px victim)."""

    def sample(self, rng, batch):
        imgs, boxes, valid = e2e.synthetic_scene_batch(rng, batch, 64)
        return (torch.from_numpy(imgs), boxes,
                np.zeros(valid.shape, np.int32), valid)


def _cfg(score_thresh=0.0099):
    cfg = pconfig.get_efficientdet_config("efficientdet-lite0")
    cfg.update(TINY)
    cfg.nms_configs.update({"score_thresh": score_thresh})
    cfg.optimizer = "sgd"
    cfg.moving_average_decay = 0.0
    return cfg


def _doc_keys(name):
    return json.loads((REPO / "docs" / name).read_text())


def _assert_keys_cover(got, want, where):
    """Every key of the TPU record is in the port's, one level into dicts
    and into the first row of lists."""
    assert set(want) <= set(got), (where, set(want) - set(got))
    for k, v in want.items():
        if isinstance(v, dict):
            assert set(v) <= set(got[k]), (where, k)
        elif isinstance(v, list) and v and isinstance(v[0], dict):
            assert got[k] and set(v[0]) <= set(got[k][0]), (where, k)


def _jax_example(name):
    path = REPO / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_synthetic_scene_batch_is_jax_bit_for_bit():
    ref = _jax_example("end_to_end_attack")
    for hw, seed in ((64, 0), (128, 5)):
        got = e2e.synthetic_scene_batch(np.random.default_rng(seed), 3, hw)
        want = ref.synthetic_scene_batch(np.random.default_rng(seed), 3, hw)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ps.cli(["--save-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ns.main(["--save-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        e2e.cli([])
    assert not os.listdir(tmp_path)


def test_end_to_end_workflow_runs_on_the_cpu(capsys):
    first, last = e2e.main(image_size=64, det_steps=1, attack_steps=2,
                           defend_steps=1, batch=BATCH, device="cpu")
    assert set(first) == set(last) and "mean_max_score" in first
    assert last["scale"] != first["scale"] or last["loss"] != first["loss"]
    assert "[defense] eval recovery loss=" in capsys.readouterr().out


def test_production_soak_gate_fails_on_a_random_victim(tmp_path):
    """One trainer step leaves the victim random: at score .5 it detects
    nobody, and the soak stops after writing the gate's record."""
    rec = ps.soak(_cfg(0.5), TinyPool(), np.random.default_rng(0),
                  str(tmp_path), det_steps=1, attack_steps=1, defend_steps=1,
                  batch=BATCH, device="cpu")
    on_disk = json.loads((tmp_path / "soak.json").read_text())
    assert on_disk["gate"] == rec["gate"] == "FAILED"
    assert on_disk["victim"]["detections"] < BATCH
    soak_doc = _doc_keys("SOAK_r03_1k.json")
    for k in ("config", "victim"):
        assert set(soak_doc[k]) <= set(on_disk[k])
    assert (tmp_path / "victim_ckpt.pkl").exists()
    assert on_disk["victim_training"][-1]["step"] == 1
    assert "attack_trajectory" not in on_disk


def test_production_soak_stages(tmp_path):
    """Gate, attack and defender on a random victim at score .0099, 2 steps
    each, every step logged."""
    cfg = _cfg()
    pool, rng = TinyPool(), np.random.default_rng(1)
    net = get_victim(cfg, seed=3, device="cpu")
    attacker = PatchAttacker(cfg, net, window=ps.WINDOW, device="cpu")
    record = {"config": {}}
    assert ps.gate(attacker, pool, rng, BATCH, record)
    assert record["victim"]["detections"] >= BATCH
    astate = ps.attack(attacker, pool, rng, str(tmp_path), attack_steps=2,
                       batch=BATCH, seed=0, log_every=1, record=record)
    traj = record["attack_trajectory"]
    assert [r["step"] for r in traj] == [1, 2]
    assert record["attack_artifact"] == str(tmp_path / f"patch_2_{traj[-1]['asr']:.3f}")
    patch, scale = artifacts.load_patch_dir(record["attack_artifact"])
    assert np.array_equal(patch, astate.patch.detach().numpy())
    assert scale == float(astate.scale.detach())
    dstate = ps.defend(cfg, net, patch, scale, pool, rng, str(tmp_path),
                       defend_steps=2, batch=BATCH, seed=0, log_every=1,
                       record=record, device="cpu")
    rows = record["defense_trajectory"]
    best = record["defense_best"]
    assert [r["step"] for r in rows] == [1, 2]
    assert best["val_loss"] == min(r["val_loss"] for r in rows)
    assert record["defense_artifact"] == best["artifact"] == str(
        tmp_path / f"patch_{best['step']}_{best['val_loss']:.4f}" / "antipatch")
    for r in rows:  # NaN only where no region was patched or no image qualifies
        assert np.isfinite(r["val_loss"]) and np.isfinite(r["train_loss"])
        assert np.isfinite(r["recovery_psnr"]) or np.isnan(r["recovery_psnr"])
    if best["step"] == 2:  # the saved U-Net is the final one
        saved = jio.load_pytree(best["artifact"])
        flat = jax.tree_util.tree_leaves
        assert all(np.array_equal(a, b) for a, b in zip(
            flat(saved), flat(bridge.torch_to_flax(dstate.unet))))
    else:
        assert jio.load_pytree(best["artifact"])["params"]
    ps.write_json(str(tmp_path / "soak.json"), record)
    _assert_keys_cover(json.loads((tmp_path / "soak.json").read_text()),
                       {k: v for k, v in _doc_keys("SOAK_r03_1k.json").items()
                        if k != "config"}, "soak.json")


def _val(n=1):
    rng = np.random.default_rng(777)
    return [torch.from_numpy(e2e.synthetic_scene_batch(rng, BATCH, 64)[0])
            for _ in range(n)]


def _config_record(epochs, spe):
    return {"config": {"model": "efficientdet-lite0", "image_size": 64,
                       "batch": BATCH, "window": 320, "bf16": False,
                       "pre_nms_topk": 64, "epochs": epochs,
                       "steps_per_epoch": spe, "val_batches": 1,
                       "eot_draws": 2, "plateau": dict(ns.PLATEAU)}}


def test_northstar_epoch_soak(tmp_path, monkeypatch):
    """Three epochs of one step with a flat validation loss and patience 1:
    the lr halves after epochs 2 and 3 and the record prints the
    optimizer's; the best artifact holds the state of its epoch; a restart
    from it starts from that patch and scale at the given lr."""
    cfg = _cfg()
    net = get_victim(cfg, seed=4, device="cpu")
    monkeypatch.setattr(ns, "PLATEAU", {"factor": 0.5, "patience": 1,
                                        "min_lr": 1e-4})
    states, calls = [], []
    real_eval = PatchAttacker.eval_step

    def flat_eval(self, state, images, batch_idx=0, **kw):
        calls.append(batch_idx)
        if batch_idx == 0:  # the first val batch of an epoch: its state
            states.append((state.patch.detach().clone(), float(state.scale.detach())))
        return real_eval(self, state, images, batch_idx, **kw)._replace(
            loss=torch.tensor(1.0))

    monkeypatch.setattr(PatchAttacker, "eval_step", flat_eval)
    record = _config_record(3, 1)
    out = str(tmp_path / "northstar.json")
    astate = ns.epoch_soak(cfg, net, TinyPool(), np.random.default_rng(2), _val(),
                           str(tmp_path), epochs=3, steps_per_epoch=1,
                           batch=BATCH, seed=0, window=320, eot_draws=2,
                           max_hours=10.0, record=record, out_json=out, device="cpu")
    on_disk = json.loads(Path(out).read_text())
    traj = on_disk["attack_trajectory"]
    assert calls == [0, 1] * 3  # batch_idx i * 7 + d, 1 batch x 2 draws
    assert [r["lr"] for r in traj] == [1e-2, 5e-3, 2.5e-3]
    assert astate.optimizer.param_groups[0]["lr"] == 2.5e-3
    for r in traj:
        assert r["val_asr_to_scale"] == r["val_asr"] / (r["scale"] + 1e-7)
        assert r["step"] == r["epoch"]
    best = on_disk["best"]
    assert best["val_asr_to_scale"] == max(r["val_asr_to_scale"] for r in traj)
    name = f"patch_{best['epoch']}_{best['val_asr_to_scale']:.4f}"
    assert best["artifact"] == str(tmp_path / name)
    patch, scale = artifacts.load_patch_dir(best["artifact"])
    want_patch, want_scale = states[best["epoch"] - 1]
    assert np.array_equal(patch, want_patch.numpy()) and scale == want_scale
    assert "stopped" not in on_disk
    doc = _doc_keys("NORTHSTAR_phase1.json")
    _assert_keys_cover(on_disk, doc, "northstar.json")
    assert set(doc["best"]) <= set(best)

    # the restart levers: patch and scale from the artifact, the given lr
    restart = ns.epoch_soak(cfg, net, TinyPool(), np.random.default_rng(2), _val(),
                            str(tmp_path / "r"), epochs=0, steps_per_epoch=1,
                            batch=BATCH, seed=0, window=320, eot_draws=2,
                            max_hours=10.0, initial_patch=best["artifact"],
                            initial_lr=2.5e-3, record=_config_record(0, 1),
                            out_json=str(tmp_path / "r.json"), device="cpu")
    assert np.array_equal(restart.patch.detach().numpy(), patch)
    assert float(restart.scale.detach()) == scale
    assert restart.optimizer.param_groups[0]["lr"] == 2.5e-3


def test_northstar_wall_clock_cap_stops_after_epoch_one(tmp_path):
    cfg = _cfg()
    net = get_victim(cfg, seed=4, device="cpu")
    record = _config_record(5, 1)
    out = str(tmp_path / "northstar.json")
    ns.epoch_soak(cfg, net, TinyPool(), np.random.default_rng(2), _val(),
                  str(tmp_path), epochs=5, steps_per_epoch=1, batch=BATCH,
                  seed=0, window=320, eot_draws=1, max_hours=0.0,
                  record=record, out_json=out, device="cpu")
    on_disk = json.loads(Path(out).read_text())
    assert len(on_disk["attack_trajectory"]) == 1
    assert on_disk["stopped"] == "wall-clock cap 0.0h at epoch 1"


def test_frontier_freezes_the_scale(tmp_path, monkeypatch):
    cfg = _cfg()
    net = get_victim(cfg, seed=4, device="cpu")
    calls, scales = [], []
    real_eval = PatchAttacker.eval_step

    def counted(self, state, images, batch_idx=0, **kw):
        calls.append(batch_idx)
        scales.append(state.scale.detach().clone())
        assert self.freeze_scale and self.window == ns.FRONTIER_WINDOW
        return real_eval(self, state, images, batch_idx, **kw)

    monkeypatch.setattr(PatchAttacker, "eval_step", counted)
    record = _config_record(500, 100)
    out = str(tmp_path / "frontier.json")
    ns.frontier(cfg, net, TinyPool(), np.random.default_rng(3), _val(2), [0.3],
                steps=2, batch=BATCH, seed=0, record=record, out_json=out, device="cpu")
    assert calls == [0, 1, 2, 3, 7, 8, 9, 10]  # 2 batches x 4 draws
    assert all(torch.equal(s, torch.tensor(0.3)) for s in scales)
    on_disk = json.loads(Path(out).read_text())
    row = on_disk["frontier"][0]
    assert row["scale"] == 0.3 and row["trajectory"] == []
    assert row["val_asr_to_scale"] == row["val_asr"] / 0.3
    _assert_keys_cover(on_disk, _doc_keys("FRONTIER.json"), "frontier.json")


def test_precision_frontier_runs_both_arms_on_one_victim(tmp_path, monkeypatch):
    """`examples/precision_frontier.run`: the bf16 and float32 arms on the
    same victim variables, each victim computing in its arm's dtype, from
    the same pool draws; the tie counts of a random victim (its scores all
    near 0.01: bf16 ties many anchors at the max, float32 none) and the
    confidence record's keys, those of `docs/VICTIM_CONFIDENCE.json`."""
    from mladversarialobjectdetection_torch.examples import precision_frontier as pf
    cfg = _cfg()
    cfg.mixed_precision = True
    variables = bridge.torch_to_flax(get_victim(cfg, seed=4, device="cpu"))
    seen, draws = [], []
    real_step = PatchAttacker.train_step

    def spy(self, state, images, **kw):
        seen.append(self.net.compute_dtype)
        draws.append(np.asarray(images).copy())
        return real_step(self, state, images, **kw)

    monkeypatch.setattr(PatchAttacker, "train_step", spy)
    out = pf.run(cfg, TinyPool(), _val(2), variables, scale=0.6, steps=2,
                 batch=BATCH, seed=0, save_dir=str(tmp_path), device="cpu")
    assert seen == [torch.bfloat16] * 2 + [torch.float32] * 2
    assert all(np.array_equal(a, b) for a, b in zip(draws[:2], draws[2:]))
    for name in ("bf16", "fp32"):
        row = out[name]
        assert row["scale"] == 0.6 and np.isfinite(row["val_asr"])
        assert (tmp_path / f"frontier_{name}.json").exists()
        assert row["max_ties"]["images"] == 2 * BATCH
    assert out["bf16"]["max_ties"]["mean"] > 1 and out["fp32"]["max_ties"]["max"] == 1
    net = get_victim(cfg, variables=variables, device="cpu")
    conf = pf.victim_confidence(PatchAttacker(cfg, net, window=48, device="cpu"),
                                _val(2))
    _assert_keys_cover(conf, {k: v for k, v in _doc_keys("VICTIM_CONFIDENCE.json").items()
                              if k != "victim"}, "victim confidence")
