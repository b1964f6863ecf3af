"""Command-line launcher: train or evaluate a scene (JAX reference:
launcher.py).

    python -m multimodalstudio_tpu_torch.launcher --mode train \
        --method grid_raw_tpu --scene synthetic_raw:views=12,size=96 --version v1
    python -m multimodalstudio_tpu_torch.launcher --mode eval \
        --method grid_raw_tpu --scene synthetic_raw:views=12,size=96 --version v1

    python -m multimodalstudio_tpu_torch.launcher --mode train \
        --method grid_raw --scene <scene directory> --version v1

`--conf_path` takes a YAML file of leaf overrides whose `method` key
selects the method (PyYAML is imported only then); `--method` alone needs
no YAML. `--scene` is a scene directory (meta_data.json and
modalities/<modality>/<frames>, as the reference's preprocessing writes
it; PNG or .npy frames, read without OpenCV), split by the config's
`eval_indices_per_modality` or `eval_image_indices` (with
`skip_indices_per_modality` dropped from training), or the built-in
analytic scene, `synthetic` or `synthetic_raw`, with optional
`:views=N,size=S,texfreq=F` (every 5th view held out for eval). The run
lives in <output>/<scene name>/<method>/<conf>/<version>, the scene name
being the directory's basename; a second call on the same directory
resumes from its newest checkpoint. Runs on the card unless `--device
cpu` is given.

Over several processes (one a card), set the process group's environment
in each (parallel/sharding.py: MMS_COORDINATOR=host:port,
MMS_NUM_PROCESSES, MMS_PROCESS_ID) and run the same command: the group is
joined before anything touches a card, rank r trains on card r (or on the
card `--device` names), and the config's n_devices (0: every process)
splits each step's global batch over them.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os

from multimodalstudio_tpu_torch.configs.config import load_config, make_output_dir
from multimodalstudio_tpu_torch.device import resolve_device


def build_datasets(config, scene: str, device="cuda"):
    """(train, eval) splits of a scene (launcher.py:27-70): of a scene
    directory by the config's eval and skip indices, or of the built-in
    synthetic scene, views, size and texfreq from the scene string, every
    view with i % 5 == 4 held out for eval."""
    if not scene.startswith("synthetic"):
        return _disk_datasets(config, scene, device)
    from multimodalstudio_tpu_torch.data.synthetic import make_synthetic_dataset

    views, size, texfreq = 12, 96, 6.0
    if ":" in scene:
        for kv in scene.split(":", 1)[1].split(","):
            k, _, v = kv.partition("=")
            if k == "views":
                views = int(v)
            elif k == "size":
                size = int(v)
            elif k == "texfreq":
                texfreq = float(v)
            else:
                raise ValueError(f"unknown synthetic scene option {kv!r}")
    kw = dict(num_views=views, height=size, width=size, raw=config.datamanager.raw,
              tex_freq=texfreq, device=device)
    train = make_synthetic_dataset(config.modalities,
                                   view_ids=[i for i in range(views) if i % 5 != 4], **kw)
    evald = make_synthetic_dataset(config.modalities,
                                   view_ids=[i for i in range(views) if i % 5 == 4], **kw)
    return train, evald


def _disk_datasets(config, scene: str, device):
    """The splits of a scene directory (launcher.py:53-70): eval views per
    modality if the config names them, else the shared eval ids (so the
    config's eval_ratio is reached only without them, as in the
    reference); skipped views leave training only."""
    from multimodalstudio_tpu_torch.data import dataset as D

    dm = config.datamanager
    eval_per_mod = None
    if dm.eval_indices_per_modality is not None:
        eval_per_mod = dict(dm.eval_indices_per_modality)
    train_idx, eval_idx = D.train_eval_indices(
        scene, config.modalities, eval_image_indices=list(dm.eval_image_indices),
        eval_indices_per_modality=eval_per_mod, eval_ratio=dm.eval_ratio)
    if dm.skip_indices_per_modality is not None:
        for mod, skips in dm.skip_indices_per_modality:
            train_idx[mod] = [i for i in train_idx[mod] if i not in set(skips)]
    train = D.load_dataset(scene, config.modalities, train_idx, raw=dm.raw, device=device)
    evald = D.load_dataset(scene, config.modalities, eval_idx, raw=dm.raw, device=device)
    return train, evald


def resolve_model_channels(config, dataset):
    """Bind each modality's channel count from the dataset into the model
    spec (launcher.py:63-72)."""
    channels = dataset.channels_per_modality
    model = dataclasses.replace(config.model,
                                modalities=tuple((m, channels[m]) for m in config.modalities))
    return dataclasses.replace(config, model=model)


def main(argv=None):
    parser = argparse.ArgumentParser(description="mms-tpu PyTorch launcher")
    parser.add_argument("--mode", choices=["train", "eval"], default="train")
    parser.add_argument("--conf_path", default=None, help="YAML config path")
    parser.add_argument("--method", default=None, help="method registry name")
    parser.add_argument("--scene", required=True,
                        help="scene directory, or 'synthetic' / 'synthetic_raw[:opts]'")
    parser.add_argument("--version", default=None, help="run version tag")
    parser.add_argument("--output", default="output", help="output root")
    parser.add_argument("--view_ids", type=int, nargs="*", default=None)
    parser.add_argument("--max_iterations", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    # join the process group before anything touches a card (launcher.py:107-113)
    from multimodalstudio_tpu_torch.parallel import sharding

    sharding.initialize_distributed(device=args.device)
    device = sharding.bind_device(resolve_device(args.device))

    config = load_config(args.conf_path, method=args.method)
    if args.max_iterations:
        config = dataclasses.replace(config, max_num_iterations=args.max_iterations)

    train_ds, eval_ds = build_datasets(config, args.scene, device=device)
    config = resolve_model_channels(config, train_ds)

    scene = args.scene.split(":", 1)[0] if args.scene.startswith("synthetic") else args.scene
    scene_name = os.path.basename(os.path.normpath(scene)) or scene
    conf_name = (os.path.splitext(os.path.basename(args.conf_path))[0] if args.conf_path
                 else config.method_name)
    # one run directory for every rank: rank 0's clock names an unnamed version
    version = args.version or sharding.broadcast_object(
        datetime.datetime.now().strftime("%Y-%m-%d_%H%M%S"))
    out_dir = make_output_dir(args.output, scene_name, config.method_name, conf_name, version)
    if sharding.is_main_process():
        print(f"output dir: {out_dir}")

    from multimodalstudio_tpu_torch.engine.trainer import Trainer

    trainer = Trainer(config, train_ds, eval_ds, out_dir, device=device)
    trainer.setup()
    if args.mode == "train":
        trainer.train()
        return None
    results = trainer.eval(view_ids=args.view_ids)
    print(results)
    return results


if __name__ == "__main__":
    main()
