"""`ops.checks.check_image_dp` on CPU ranks: the check that ``chip_smoke.py
--nccl`` runs on four cards, here at world 4 over Gloo, 2 steps of global
batch 16 (the card runs 10 of 128).  Every rank built ResNet-18 from its
own seed; after the Trainer's broadcast and two steps whose all-reduce
carries the gradients, the loss and the 40 batch-norm buffers, every
parameter and buffer holds the same bits on every rank."""

from tpu_dist_torch.ops import checks


def test_resnet18_world_four_ranks_hold_the_same_bits():
    res = checks.check_image_dp(4, steps=2, batch=16, device="cpu")
    assert res["elements_differing"] == 0
    assert res["batch_norm_buffers"] == 40
    assert res["tensors_compared"] == 1 + 62 + 40  # losses, parameters, buffers
    assert res["dense_launches"] == [0, 0, 0, 0]  # CPU tensors: the plain version
    # the first step timed apart from the later ones, on every rank
    assert len(res["first_step_seconds"]) == len(res["later_seconds_per_step"]) == 4
    assert all(t > 0 for t in res["first_step_seconds"] + res["later_seconds_per_step"])
