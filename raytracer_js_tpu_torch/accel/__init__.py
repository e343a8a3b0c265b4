"""Acceleration structures (port of ``raytracer_js_tpu.accel``): the
per-tile candidate tables of the TILED frame entry (``candidates``) and the
flat octree of the OCTREE backend (``octree``: ``OctreeAccel``,
``build_octree``)."""
