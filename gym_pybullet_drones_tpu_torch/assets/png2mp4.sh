#!/bin/sh
# PNG sequence -> video (the port's copy of the JAX package's assets/png2mp4.sh,
# the reference's assets/ffmpeg_png2mp4.sh).
# Usage: png2mp4.sh <png_dir> [out.mp4] [fps]
# Prefers ffmpeg; falls back to the pure-Python MJPEG-AVI muxer
# (gym_pybullet_drones_tpu_torch.utils.video) when ffmpeg is absent.
set -e
DIR="${1:?usage: png2mp4.sh <png_dir> [out.mp4] [fps]}"
OUT="${2:-$DIR/video.mp4}"
FPS="${3:-24}"
if command -v ffmpeg >/dev/null 2>&1; then
  ffmpeg -y -framerate "$FPS" -pattern_type glob -i "$DIR/*.png" \
         -pix_fmt yuv420p "$OUT"
else
  python -c "from gym_pybullet_drones_tpu_torch.utils.video import png_dir_to_video; \
print(png_dir_to_video('$DIR', '$OUT', fps=$FPS))"
fi
