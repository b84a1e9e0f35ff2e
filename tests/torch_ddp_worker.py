"""Worker of tests/test_torch_ddp.py (not a test module).

    RANK=r WORLD_SIZE=2 MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_ddp_worker.py <workdir>

Joins the gloo group through `audiolcm_torch.parallel.mesh.init_distributed`,
then writes <workdir>/rank<r>.pt with:
  names    the sample names of this rank's shard of the loader;
  lcm      one LCM distillation step with the student in DDP (SGD lr 1,
           draws from a generator seeded alike on both ranks): loss,
           grad_norm and the updated student;
  vae_gan  one VAE-GAN generator + discriminator step (SGD lr 1): metrics,
           the updated VAE and discriminator (running statistics included);
  voc      one vocoder discriminator + generator step: metrics and the
           updated generator and MPD;
  dis      one generator + discriminator step of the "dis" VAE loss
           variant: metrics, the updated VAE and both towers.
Each rank feeds its half of one global batch built by `build` in the test.
"""

import os
import sys

import torch


def main():
    workdir = sys.argv[1]
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [os.path.dirname(here), here]  # the repo and tests/, as pytest has them
    from audiolcm_torch.data.datasets import BucketedBatchLoader, SpecDataset
    from audiolcm_torch.parallel import mesh
    from tests.test_torch_ddp import build, run_steps

    assert mesh.init_distributed(torch.device("cpu"))
    assert mesh.world_size() == 2
    loader = BucketedBatchLoader(SpecDataset("test", workdir, mel_num=8), batch_size=2,
                                 num_replicas=mesh.world_size(), rank=mesh.rank(), shuffle=False)
    names = [n for batch in loader for n in batch["names"]]
    out = run_steps(build(), mesh.shard_slice(2))
    torch.save({"names": names, **out}, os.path.join(workdir, f"rank{mesh.rank()}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
