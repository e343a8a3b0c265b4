"""The benchmark's plain reference: a dense-search raytracer in plain PyTorch.

It decides whether what the timed path produced is correct. It imports
``torch`` and ``numpy`` only: nothing of the program under test, nothing of
the JAX package. It builds its scene, cameras and rays again from
the benchmark's own scene description (:class:`scene.SceneSpec`), so it
takes nothing the program made.

It is a frozen copy of the wavefront trace loop with the dense search (the
port's BRUTE path as of its first benchmark), cut to the scene class the
benchmark's configurations use: spheres and boxes, solid textures and a
solid sky, REFLECTION materials (diffuse, mirror, emissive), no roughness,
transmission or triangles. A scene outside that class raises.
"""
