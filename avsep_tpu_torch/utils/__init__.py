"""Host-side helpers: running meters and the history dict, media dumps
(spectrogram heatmaps, ffmpeg video), loss and metric plots.  numpy only;
cv2, imageio, matplotlib and ffmpeg are imported by the functions that use
them."""
