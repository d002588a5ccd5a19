"""The data layer: PNG (``png``) and PFM (``io``) files, the SceneFlow and
KITTI datasets (``datasets``), their augmentations (``transforms``), the
benchmark loaders, the host loader (``loader``) and synthetic scenes."""
