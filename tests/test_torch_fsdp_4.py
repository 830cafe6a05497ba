"""``tests/test_torch_fsdp.py``'s checks on 4 gloo ranks: the FSDP train
state placed on (4, 1) and (2, 2), its gather's forward and backward
over 4 data ranks, its masks there, and every family's three AdamW
steps on (2, 2) against one rank and against (2, 2) without FSDP, and
the dry run's census of that step against every rank's count."""
import pytest
import torch

import _parallel_workers as W
from test_torch_fsdp import (check_arg_bytes, check_census,
                             check_census_bytes, check_checkpoint,
                             check_gather, check_masks, check_once,
                             check_regather, check_round_trip, check_steps,
                             ranks_of)

WORLD = 4

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return ranks_of(WORLD, tmp_path_factory)[0]


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    return ranks_of(WORLD, tmp_path_factory)[1]


@pytest.mark.parametrize("mp", W.fsdp_meshes(WORLD))
@pytest.mark.parametrize("name", W.FSDP_FAMILIES)
def test_fsdp_state_places_and_gathers_back_4(ranks, name, mp):
    """Each family's train state FSDP-placed on (4, 1) and (2, 2)."""
    check_round_trip(ranks, name, mp)


@pytest.mark.parametrize("key", [f"{dt} {d}" for dt in
                                 (torch.float32, torch.bfloat16)
                                 for d in range(3)])
def test_gather_blocks_forward_and_backward_4(ranks, key):
    """Over 4 data ranks the summed gradient is the f32 sum (bf16 rounded
    once), to the order of its additions."""
    check_gather(ranks, WORLD, key)


def test_regathering_keeps_no_whole_leaf_4(ranks):
    check_regather(ranks)


@pytest.mark.parametrize("mp", W.fsdp_meshes(WORLD))
@pytest.mark.parametrize("name", W.FSDP_FAMILIES)
def test_fsdp_masks_are_one_rank_blocks_4(ranks, name, mp):
    """On (2, 2) a leaf split over "model" and "data" counts each halving
    over both; a leaf split over one of them counts on its replicas along
    the other once."""
    check_masks(ranks, name, mp)


@pytest.mark.parametrize("name", W.FSDP_FAMILIES)
def test_fsdp_steps_match_one_rank_4(ranks, name):
    """Three AdamW steps on (2, 2) FSDP-placed against one rank and
    against (2, 2) without FSDP."""
    check_steps(ranks, name, 2)


@pytest.mark.parametrize("name", W.FSDP_FAMILIES)
def test_fsdp_sums_each_gradient_once_4(ranks, name):
    check_once(ranks, name, 2, WORLD)


@pytest.mark.parametrize("name", W.FSDP_FAMILIES)
def test_fsdp_checkpoint_restores_in_one_process_4(ranks, out_dir, name):
    check_checkpoint(ranks, out_dir, name, 2)


def test_dry_run_bytes_equal_a_fsdp_rank_4(ranks):
    check_arg_bytes(ranks, WORLD, W.fsdp_step_mesh(WORLD))


@pytest.mark.parametrize("name", W.FSDP_FAMILIES)
def test_census_equals_every_fsdp_rank_4(ranks, name):
    """On (2, 2) the census counts the "model" axis's collectives beside
    the FSDP gathers, each as every rank ran it."""
    check_census(ranks, name, W.fsdp_step_mesh(WORLD), WORLD)


def test_fsdp_census_bytes_follow_the_specs_4(ranks):
    check_census_bytes(ranks, WORLD, W.fsdp_step_mesh(WORLD))
