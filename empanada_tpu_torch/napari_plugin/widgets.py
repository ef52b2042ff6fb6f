"""magicgui widget adapters over the port's headless layers (counterpart of
``empanada_tpu/napari_plugin/widgets.py``, factory for factory).

Each factory delegates to the functions the command line drives
(``python -m empanada_tpu_torch``), so behaviour is the same in and out of
the GUI.  napari and magicgui import lazily: importing this module without
them works; CREATING a widget raises an informative ``ImportError``.

The inference, training and finetuning widgets run on the card through the
port's engines and loops; their ``device`` field (default "cuda") is the
command line's ``--device``.  A registered model's config is read with
``api.utils.load_config`` (its ``BASE`` parents applied), not passed on as
its yaml path.
"""

from __future__ import annotations

from typing import List  # noqa: F401 - resolved by magicgui's type hints

import numpy as np

__all__ = [
    "open_documentation",
    "slice_inference_widget",
    "volume_inference_widget",
    "export_batch_segs",
    "label_counter_widget",
    "merge_labels_widget",
    "delete_labels_widget",
    "morph_labels_widget",
    "split_labels_widget",
    "filter_small_labels_widget",
    "jump_to_label_widget",
    "find_next_available_label_widget",
    "pick_patches_widget",
    "visualize_patches_widget",
    "store_dataset_widget",
    "finetuning_widget",
    "training_widget",
    "register_model_widget",
    "get_info_widget",
    "export_model_widget",
    "import_model_widget",
    "archive_model_widget",
    "create_tiles_widget",
    "merge_tiles_widget",
]


def _magicgui():
    try:
        from magicgui import magicgui
    except ImportError as e:
        raise ImportError(
            "empanada_tpu_torch's napari widgets need napari + magicgui "
            "(`pip install 'napari[all]'`); the headless command line "
            "(`python -m empanada_tpu_torch`) provides the same features."
        ) from e
    return magicgui


def _points(points_layer):
    """Points layer -> int ndarray of coordinates (or None when empty)."""
    if points_layer is not None and len(points_layer.data):
        return np.asarray(points_layer.data).astype(int)
    return None


def _model_choices():
    from empanada_tpu_torch.api.utils import get_configs

    return sorted(get_configs().keys()) or ["MitoNet_v1"]


def open_documentation():
    import webbrowser

    webbrowser.open("https://empanada.readthedocs.io/en/latest/")


def slice_inference_widget():
    """2D inference on the viewer's active image layer (the current slice of
    a stack)."""
    magicgui = _magicgui()

    @magicgui(
        call_button="Run 2D Inference",
        model_name=dict(choices=_model_choices()),
        downsampling=dict(choices=[1, 2, 4, 8, 16, 32, 64]),
    )
    def widget(
        viewer: "napari.Viewer",  # noqa: F821
        image_layer: "napari.layers.Image",  # noqa: F821
        model_name: str = "MitoNet_v1",
        downsampling: int = 1,
        center_confidence: float = 0.1,
        nms_kernel: int = 3,
        segment_confidence: float = 0.3,
        fine_boundaries: bool = False,
        semantic_only: bool = False,
        tile_size: int = 0,
        spatial_shard: bool = False,
        max_objects_per_class: int = 10000,
        device: str = "cuda",
    ) -> "napari.types.LayerDataTuple":  # noqa: F821
        from empanada_tpu_torch.api import Engine2d
        from empanada_tpu_torch.api.utils import load_config

        engine = Engine2d(
            load_config(model_name),
            inference_scale=downsampling,
            nms_threshold=center_confidence,
            nms_kernel=nms_kernel,
            confidence_thr=segment_confidence,
            fine_boundaries=fine_boundaries,
            semantic_only=semantic_only,
            tile_size=tile_size,
            spatial_shard=spatial_shard,
            label_divisor=max_objects_per_class,
            device=device,
        )
        image = np.asarray(image_layer.data)
        if image.ndim == 3:
            image = image[int(viewer.dims.current_step[0])]
        pan = engine.infer(image)
        return (pan, {"name": f"{image_layer.name}_panoptic"}, "labels")

    return widget


def volume_inference_widget():
    """3D stack or ortho-plane inference: one Labels layer per class."""
    magicgui = _magicgui()

    @magicgui(
        call_button="Run 3D Inference",
        model_name=dict(choices=_model_choices()),
    )
    def widget(
        image_layer: "napari.layers.Image",  # noqa: F821
        model_name: str = "MitoNet_v1",
        median_slices: int = 3,
        orthoplane: bool = False,
        multichip: bool = False,
        min_size: int = 500,
        min_extent: int = 5,
        pixel_vote_thr: int = 2,
        allow_one_view: bool = False,
        max_objects_per_class: int = 10000,
        checkpoint_dir: str = "",
        resume: bool = False,
        device: str = "cuda",
    ) -> "List[napari.types.LayerDataTuple]":  # noqa: F821
        from empanada_tpu_torch import api
        from empanada_tpu_torch.api.utils import load_config

        config = load_config(model_name)
        cls = api.Engine3d
        if multichip:
            from empanada_tpu_torch.parallel import MultiChipEngine3d as cls  # noqa: N813

        engine = cls(
            config,
            median_kernel_size=median_slices,
            min_size=min_size,
            min_extent=min_extent,
            label_divisor=max_objects_per_class,
            device=device,
        )
        ckpt_kw = {}
        if checkpoint_dir:
            ckpt_kw = dict(checkpoint_dir=checkpoint_dir, resume=resume)
        volume = np.asarray(image_layer.data)
        if orthoplane:
            trackers = engine.infer_orthoplane(volume, **ckpt_kw)
            outs = list(api.tracker_consensus(
                trackers, None, config, pixel_vote_thr=pixel_vote_thr,
                allow_one_view=allow_one_view, min_size=min_size, min_extent=min_extent,
                device=device))
        else:
            _, axis_trackers = engine.infer_on_axis(volume, "xy", **ckpt_kw)
            outs = list(api.stack_postprocessing(
                {"xy": axis_trackers}, None, config, min_size=min_size,
                min_extent=min_extent, device=device))
        return [(np.asarray(vol), {"name": f"{class_name}_seg"}, "labels")
                for vol, class_name, _ in outs]

    return widget


def export_batch_segs():
    magicgui = _magicgui()

    @magicgui(call_button="Export", save_dir=dict(mode="d"))
    def widget(
        labels_layer: "napari.layers.Labels",  # noqa: F821
        save_dir: str = ".",
        as_stack: bool = False,
    ):
        from empanada_tpu_torch.curation.export import export_segmentations

        export_segmentations(np.asarray(labels_layer.data), save_dir,
                             prefix=labels_layer.name, as_stack=as_stack)

    return widget


def label_counter_widget():
    magicgui = _magicgui()

    @magicgui(call_button="Count Labels")
    def widget(
        labels_layer: "napari.layers.Labels",  # noqa: F821
        label_divisor: int = 1000,
    ) -> str:
        from empanada_tpu_torch.curation.count import count_labels

        counts, _ = count_labels(np.asarray(labels_layer.data), label_divisor)
        return "\n".join(f"class {c}: {len(v)} labels" for c, v in counts.items())

    return widget


def _labels_op_widget(op_name, call_button):
    """The point-selection label edits: ``op_name`` of ``curation.ops`` on
    the labels layer, the points layer as the selection, which is then
    emptied."""
    magicgui = _magicgui()
    from empanada_tpu_torch.curation import ops

    @magicgui(call_button=call_button)
    def widget(
        labels_layer: "napari.layers.Labels",  # noqa: F821
        points_layer: "napari.layers.Points" = None,  # noqa: F821
    ):
        points = _points(points_layer)
        fn = getattr(ops, op_name)
        labels_layer.data = fn(np.asarray(labels_layer.data), points=points)
        if points_layer is not None:
            points_layer.data = np.empty((0, points_layer.ndim))

    return widget


def merge_labels_widget():
    return _labels_op_widget("merge_labels", "Merge Labels")


def delete_labels_widget():
    return _labels_op_widget("delete_labels", "Delete Labels")


def morph_labels_widget():
    magicgui = _magicgui()

    @magicgui(
        call_button="Morph Labels",
        operation=dict(choices=["dilate", "erode", "open", "close", "fill_holes"]),
    )
    def widget(
        labels_layer: "napari.layers.Labels",  # noqa: F821
        points_layer: "napari.layers.Points" = None,  # noqa: F821
        operation: str = "dilate",
        radius: int = 1,
        hole_size: int = 64,
        apply3d: bool = False,
    ):
        from empanada_tpu_torch.curation.ops import morph_labels

        labels_layer.data = morph_labels(
            np.asarray(labels_layer.data), points=_points(points_layer),
            operation=operation, radius=radius, hole_size=hole_size, apply3d=apply3d)

    return widget


def split_labels_widget():
    magicgui = _magicgui()

    @magicgui(call_button="Split Labels")
    def widget(
        labels_layer: "napari.layers.Labels",  # noqa: F821
        points_layer: "napari.layers.Points" = None,  # noqa: F821
        min_distance: int = 10,
        points_as_markers: bool = False,
        apply3d: bool = False,
    ):
        from empanada_tpu_torch.curation.ops import split_labels

        labels_layer.data = split_labels(
            np.asarray(labels_layer.data), points=_points(points_layer),
            min_distance=min_distance, points_as_markers=points_as_markers,
            apply3d=apply3d)

    return widget


def filter_small_labels_widget():
    magicgui = _magicgui()

    @magicgui(
        call_button="Filter Labels",
        mode=dict(choices=["image", "patches", "volume"]),
        filter=dict(choices=["small", "boundary"]),
    )
    def widget(
        labels_layer: "napari.layers.Labels",  # noqa: F821
        minimum_area: int = 100,
        filter: str = "small",
        mode: str = "image",
    ) -> str:
        from empanada_tpu_torch.curation.filters import apply_label_filter

        filtered, n_removed = apply_label_filter(
            np.asarray(labels_layer.data), mode=mode, filter=filter,
            minimum_area_allowed=minimum_area)
        labels_layer.data = filtered
        return f"removed {n_removed} labels"

    return widget


def jump_to_label_widget():
    magicgui = _magicgui()

    @magicgui(call_button="Jump")
    def widget(
        viewer: "napari.Viewer",  # noqa: F821
        labels_layer: "napari.layers.Labels",  # noqa: F821
        label_id: int = 1,
    ) -> str:
        from empanada_tpu_torch.curation.ops import jump_to_label

        try:
            box = jump_to_label(np.asarray(labels_layer.data), label_id)
        except KeyError:
            return f"label {label_id} not found"
        nd = len(box) // 2
        center = [(box[i] + box[i + nd]) // 2 for i in range(nd)]
        if nd == 3:
            viewer.dims.set_point(0, int(center[0]))
        # napari's Camera.center is a (z, y, x) 3-tuple; z is unused in 2D
        viewer.camera.center = (0.0, float(center[-2]), float(center[-1]))
        return f"label {label_id} at {tuple(center)}"

    return widget


def find_next_available_label_widget():
    magicgui = _magicgui()

    @magicgui(call_button="Find Next Label")
    def widget(
        labels_layer: "napari.layers.Labels",  # noqa: F821
        class_id: int = 1,
        label_divisor: int = 1000,
    ) -> int:
        from empanada_tpu_torch.curation.ops import find_next_available_label

        nxt = find_next_available_label(np.asarray(labels_layer.data), class_id,
                                        label_divisor)
        labels_layer.selected_label = nxt
        return nxt

    return widget


def pick_patches_widget():
    magicgui = _magicgui()

    @magicgui(call_button="Pick Patches")
    def widget(
        image_layer: "napari.layers.Image",  # noqa: F821
        points_layer: "napari.layers.Points" = None,  # noqa: F821
        n_patches: int = 4,
        patch_size: int = 256,
        flipbooks: bool = False,
    ) -> "napari.types.LayerDataTuple":  # noqa: F821
        from empanada_tpu_torch.curation.patches import pick_flipbooks, pick_patches_2d

        points = _points(points_layer)
        image = np.asarray(image_layer.data)
        if flipbooks:
            patches = pick_flipbooks(image, points=points, n_flipbooks=n_patches,
                                     patch_size=patch_size)
        elif image.ndim == 3:
            # 2D patches of a volume: a plane per point (or at random), then
            # a crop within that plane
            rng = np.random.default_rng(0)
            if points is None:
                picks = [(int(rng.integers(0, image.shape[0])), None)
                         for _ in range(n_patches)]
            else:
                picks = [(int(p[0]), p[None, -2:]) for p in points]
            patches = []
            for plane, pt in picks:
                patches.extend(pick_patches_2d(image[plane], points=pt, n_patches=1,
                                               patch_size=patch_size, plane=plane))
        else:
            patches = pick_patches_2d(image, points=points, n_patches=n_patches,
                                      patch_size=patch_size)
        stack = np.stack([p["image"] for p in patches])
        return (stack, {"name": f"{image_layer.name}_patches"}, "image")

    return widget


def visualize_patches_widget():
    magicgui = _magicgui()

    @magicgui(call_button="Visualize patches")
    def widget(
        points_layer: "napari.layers.Points",  # noqa: F821
        tile_width: int = 512,
    ) -> "napari.types.LayerDataTuple":  # noqa: F821
        from empanada_tpu_torch.curation.patches import patch_boxes_from_points

        # float centres: the boxes truncate after +/- half a tile
        if points_layer is None or not len(points_layer.data):
            raise ValueError("No points in the points layer.")
        points = np.asarray(points_layer.data, dtype=float)
        rects = patch_boxes_from_points(points, tile_width)
        return (rects, {"name": "Patches", "shape_type": "rectangle"}, "shapes")

    return widget


def store_dataset_widget():
    magicgui = _magicgui()

    @magicgui(call_button="Save Patches", save_dir=dict(mode="d"))
    def widget(
        image_layer: "napari.layers.Image",  # noqa: F821
        labels_layer: "napari.layers.Labels",  # noqa: F821
        save_dir: str = ".",
        prefix: str = "dataset",
    ):
        from empanada_tpu_torch.curation.patches import store_dataset

        imgs = np.asarray(image_layer.data)
        msks = np.asarray(labels_layer.data)
        if imgs.ndim == 2:  # a 2D pair is ONE patch
            patches = [{"image": imgs, "mask": msks}]
        else:
            patches = [{"image": img, "mask": msk} for img, msk in zip(imgs, msks)]
        store_dataset(save_dir, prefix, patches)

    return widget


def training_widget():
    """A training config from the fields, run by ``train.main`` in a napari
    worker thread."""
    magicgui = _magicgui()

    @magicgui(call_button="Train", train_dir=dict(mode="d"), model_dir=dict(mode="d"))
    def widget(
        model_name: str = "my_model",
        train_dir: str = ".",
        model_dir: str = ".",
        architecture: str = "PanopticDeepLab",
        encoder: str = "resnet50",
        iterations: int = 500,
        batch_size: int = 16,
        multichip: bool = False,
        device: str = "cuda",
    ):
        from napari.qt.threading import thread_worker

        from empanada_tpu_torch.train import main as train_main

        config = {
            "model_name": model_name,
            "MODEL": {"arch": architecture, "encoder": encoder},
            "DATASET": {"class_names": {1: "object"}, "labels": [1],
                        "thing_list": [1], "norms": {"mean": 0.5, "std": 0.25}},
            "TRAIN": {
                "train_dir": train_dir, "model_dir": model_dir,
                "batch_size": batch_size, "epochs": max(1, iterations // 100),
                "multichip": multichip,
                "criterion": "PanopticLoss",
                "dataset_class": "SingleClassInstanceDataset",
                "augmentations": [{"aug": "RandomCrop", "height": 256, "width": 256}],
            },
        }

        @thread_worker
        def run():
            train_main(config, device=device)

        run().start()

    return widget


def finetuning_widget():
    magicgui = _magicgui()

    @magicgui(
        call_button="Finetune",
        model_name=dict(choices=_model_choices()),
        train_dir=dict(mode="d"), model_dir=dict(mode="d"),
    )
    def widget(
        model_name: str = "MitoNet_v1",
        new_model_name: str = "finetuned",
        train_dir: str = ".",
        model_dir: str = ".",
        iterations: int = 100,
        finetune_layer: str = "none",
        device: str = "cuda",
    ):
        from napari.qt.threading import thread_worker

        from empanada_tpu_torch.api.utils import load_config
        from empanada_tpu_torch.train import finetune_main

        config = {
            "model_name": new_model_name,
            "model_config": load_config(model_name),
            "TRAIN": {
                "train_dir": train_dir, "model_dir": model_dir,
                "epochs": max(1, iterations // 100),
                "finetune_layer": finetune_layer,
            },
        }

        @thread_worker
        def run():
            finetune_main(config, device=device)

        run().start()

    return widget


def register_model_widget():
    magicgui = _magicgui()

    @magicgui(call_button="Register Model")
    def widget(model_name: str = "", config_file: str = "", model_file: str = ""):
        import yaml

        from empanada_tpu_torch.api.utils import add_new_model

        with open(config_file) as f:
            config = yaml.safe_load(f)
        add_new_model(model_name, config, model_file or None)

    return widget


def get_info_widget():
    magicgui = _magicgui()

    @magicgui(call_button="Get Info", model_name=dict(choices=_model_choices()))
    def widget(model_name: str = "MitoNet_v1") -> str:
        from empanada_tpu_torch.api.utils import model_info_text

        return model_info_text(model_name)

    return widget


def export_model_widget():
    magicgui = _magicgui()

    @magicgui(call_button="Export Model", export_dir=dict(mode="d"),
              model_name=dict(choices=_model_choices()))
    def widget(model_name: str = "MitoNet_v1", export_dir: str = ".",
               quantize: bool = False) -> str:
        from empanada_tpu_torch.api.export import export_model

        return export_model(model_name, export_dir, quantize=quantize)

    return widget


def import_model_widget():
    magicgui = _magicgui()

    @magicgui(call_button="Import Model")
    def widget(archive_path: str = "", model_name: str = "") -> str:
        from empanada_tpu_torch.api.export import import_model

        return import_model(archive_path, model_name or None)

    return widget


def archive_model_widget():
    magicgui = _magicgui()

    @magicgui(call_button="Archive Model", archive_dir=dict(mode="d"),
              model_name=dict(choices=_model_choices()))
    def widget(model_name: str = "MitoNet_v1", archive_dir: str = ".") -> str:
        from empanada_tpu_torch.api.export import archive_model

        return archive_model(model_name, archive_dir)

    return widget


def create_tiles_widget():
    magicgui = _magicgui()

    @magicgui(call_button="Create Tiles", save_directory=dict(mode="d"))
    def widget(image_path: str = "", save_directory: str = ".", patch_size: int = 2048):
        from empanada_tpu_torch.curation.tiles import chop_into_tiles

        chop_into_tiles(image_path, save_directory, patch_size=patch_size)

    return widget


def merge_tiles_widget():
    magicgui = _magicgui()

    @magicgui(call_button="Merge Tiles", patch_directory=dict(mode="d"),
              save_directory=dict(mode="d"))
    def widget(patch_directory: str = "", save_directory: str = "."):
        from empanada_tpu_torch.curation.tiles import merge_tiles

        merge_tiles(patch_directory, save_directory)

    return widget
