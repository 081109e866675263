"""The reference follows another run's choices by kind and shape, in their
order, and makes its own where that run made none such."""

import torch

from portbench.reference import choices as ch


def test_forced_by_kind_and_shape_in_order():
    scores = torch.tensor([[0.1, 0.9, 0.5, 0.3]])
    forced = [("topk", torch.tensor([[2, 1]])), ("nms", torch.tensor([[0]])), ("topk", torch.tensor([[1, 2, 3]]))]
    c = ch.Choices("force", forced)
    with ch.choices(c):
        _, a = ch.topk("level1", scores, 2)
        _, b = ch.topk("level0", scores, 3)
        _, again = ch.topk("level1", scores, 2)  # a checkpointed block asks again
    assert a.tolist() == [[2, 1]] and b.tolist() == [[1, 2, 3]] and again.tolist() == [[2, 1]]
    assert c.gaps["level1"] > 0 and c.unforced == []


def test_no_forced_choice_left_the_reference_chooses():
    scores = torch.tensor([[0.1, 0.9, 0.5, 0.3]])
    c = ch.Choices("force", [("topk", torch.tensor([[1, 2, 3]]))])
    with ch.choices(c):
        _, a = ch.topk("global_sort", scores, 2)  # no (1, 2) top-k was recorded
        _, b = ch.topk("proposal", scores, 3)
    assert a.tolist() == [[1, 2]] and b.tolist() == [[1, 2, 3]]
    assert c.unforced == ["global_sort"] and "global_sort" not in c.gaps


def test_recorded_once_a_site():
    scores = torch.tensor([[0.1, 0.9, 0.5, 0.3]])
    c = ch.Choices("record")
    with ch.choices(c):
        ch.topk("enc0_pre", scores, 2)
        ch.topk("enc0_pre", scores, 2)
        ch.topk("post", scores, 1)
    assert [k for k, _ in c.records] == ["topk", "post"]
