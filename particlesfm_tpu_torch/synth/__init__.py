from .render import Scene, random_scene
