"""The comparison that decides `correct`, driven through a whole run on the
CPU at a tiny size: a sound run comes out correct, and each fault the
frontend step can have, planted under the timed path, comes out not
correct.  The chip's own look is skipped (the run is handed device
"cpu"); the limits are the configuration's own cell's."""

import pytest
import torch

from portbench import harness

SEED = 2 ** 40 + 12345


def driver(root):
    return harness.load_module(root, "drivers", "frontend_step")


def run(root, cell, program=None):
    return harness.run_cell(root, cell, SEED, 1.0, False, device="cpu",
                            program=program, workers=0)


@pytest.mark.parametrize("cell", ["tiny-f32", "tiny-bf16"])
def test_sound_run_is_correct(tiny_root, cell):
    res = run(tiny_root, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


def faulty(root, fault):
    Port = driver(root).PortProgram

    class Faulty(Port):
        late = None

        def hand_in(self, images, prev):
            if fault == "half_batch":
                # half of the batch left out: its rows served the first
                # half's features
                h = images.shape[0] // 2
                feats = self.extract(images[:h])
                feats = type(feats)(*[None if t is None else
                                      torch.cat([t, t]) for t in feats])
            else:
                feats = self.extract(images)
            if fault == "stale":
                # the state left unchanged for a step: each step returns
                # the previous step's features
                feats, self.late = (self.late or feats), feats
            if fault == "keypoint":
                with torch.inference_mode():
                    feats.uv[0, 0, 0] += 3.0
            p = feats if prev is None else prev
            m12, _, _ = self.match_init_batch(
                p.desc, p.valid, p.uv, feats.desc, feats.uv, feats.valid,
                window=self.window, ratio=self.ratio)
            if fault == "match":
                with torch.inference_mode():
                    row = int(torch.nonzero(m12[0] >= 0)[0, 0])
                    n = int(feats.valid[0].sum())
                    m12[0, row] = (m12[0, row] + 1) % n
            return feats, m12

    return Faulty


@pytest.mark.parametrize("cell", ["tiny-f32", "tiny-bf16"])
@pytest.mark.parametrize("fault", ["stale", "half_batch", "match",
                                   "keypoint"])
def test_fault_is_not_correct(tiny_root, cell, fault):
    res = run(tiny_root, cell, faulty(tiny_root, fault))
    assert not res["correct"], res["checks"]
