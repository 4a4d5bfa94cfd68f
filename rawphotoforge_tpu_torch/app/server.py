"""Interactive preview server — the framework's L6/UI surface, on the
port: the JAX package's ``app/server.py`` with the same page, endpoints
and request contract (docs/API.md, "Web UI (``serve``)").

The reference ships three UIs (web/main.ts, Godot main.gd, tkinter
raw_photo_forge.py) all with the same shape: slider edits -> re-render at a
preview resolution (drag->LOW, release->MID, export->FULL,
web/main.ts:900-907) -> present, plus curve editors (tone_curve_editor.ts),
histogram overlay, EXIF table, masks, presets, settings and i18n. This
module provides that surface as a local HTTP app: a single-page UI (vanilla
JS sliders + a draggable-control-point curve editor with client-side PCHIP
preview + histogram canvas) talking JSON to a PhotoEditor session, with
previews streamed as JPEG.

Sessions live on one device, resolved once (``serve(device=...)``; the
card unless the caller asks for the CPU): every editor an ``/open`` builds
lands there. An ``/open`` answers from the host decode and its instant
preview while the device phase runs on a background thread (the instant
era: edits render on the host through ``engine/hostdev`` and replay onto
the session at the swap). Slider drags (LOW previews) render on the host
from a once-fetched copy of the LOW original unless ``host_drag`` is off;
MID/FULL renders, histograms, smart masks and exports run on the card.
The handler threads and the open thread launch kernels on the shared
default stream, which orders a tensor rendered on one thread before its
read on another.

Run:  python -m rawphotoforge_tpu_torch.app.server [--port 8080]
      [--device cuda|cpu] [image]
"""

from __future__ import annotations

import json
import sys
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .._device import resolve_device
from ..core.params import CURVE_NAMES
from ..engine.editor import PhotoEditor, FULL, MID, LOW
from ..engine.session import Settings
from ..io import image_io
from .translations import exif_labels, tr

_PAGE = """<!DOCTYPE html>
<html><head><title>{app_title}</title><style>
body{{font-family:sans-serif;display:flex;margin:0;background:#222;color:#ddd}}
#side{{width:320px;padding:12px;overflow-y:auto;height:100vh;box-sizing:border-box}}
#main{{flex:1;display:flex;flex-direction:column;align-items:center;padding:10px}}
#pwrap{{position:relative;display:inline-block}}
#preview{{max-width:100%;max-height:85vh;display:block}}
#croprect{{position:absolute;border:1px dashed #fc6;background:rgba(255,204,102,.15);
  pointer-events:none;display:none}}
label{{display:block;font-size:12px;margin-top:6px}}
input[type=range]{{width:100%}}
canvas{{background:#111;width:100%;touch-action:none}}
button,select{{margin:3px 2px;background:#333;color:#ddd;border:1px solid #555}}
button.armed{{background:#675527}}
a{{color:#8cf}}
#tabhdr{{display:flex;flex-wrap:wrap;border-bottom:1px solid #555;margin-top:8px}}
#tabhdr button{{flex:1;font-size:11px;padding:3px 2px;margin:0;border:none;
  background:#2a2a2a;white-space:nowrap}}
#tabhdr button.active{{background:#444;color:#fff}}
.pane{{display:none;padding-top:4px}}
.pane.active{{display:block}}
</style></head><body>
<div id=side>
  <h3>{app_title}</h3>
  <div>
    <button onclick="document.getElementById('fopen').click()">{open_file}</button>
    <input id=fopen type=file style="display:none"
      accept=".jpg,.jpeg,.png,.webp,.tif,.tiff,.ppm,.dng,.cr2,.nef,.arw,.rw2,.raf,.cr3,.x3f,.orf,.pef,.srw">
    <a id=dl href="#" onclick="asyncExport('jpeg','export.jpg');return false">{export_jpeg}</a>
    <a href="#" onclick="asyncExport('png','export.png');return false">PNG</a>
    <a href="#" onclick="asyncExport('png16','export.png');return false">PNG-16</a>
    <a href="#" onclick="asyncExport('dng','export_hdr.dng');return false">HDR</a>
    <span id=exp_status></span> <span id=open_status></span>
  </div>
  <canvas id=hist width=256 height=70></canvas>
  <div id=tabhdr>
    <button data-tab=tone class=active>{tab_tone}</button>
    <button data-tab=brightness>{brightness}</button>
    <button data-tab=hue>{hue}</button>
    <button data-tab=saturation>{saturation}</button>
    <button data-tab=lightness>{lightness}</button>
    <button data-tab=wb>{tab_wb}</button>
    <button data-tab=effect>{tab_effect}</button>
    <button data-tab=metadata>{metadata}</button>
  </div>
  <div id=pane_tone class="pane active"><div id=sl_tone></div>
    <button onclick="resetTab('tone')">{reset_tab}</button></div>
  <div id=pane_brightness class=pane></div>
  <div id=pane_hue class=pane></div>
  <div id=pane_saturation class=pane></div>
  <div id=pane_lightness class=pane></div>
  <div id=pane_wb class=pane><div id=sl_wb></div>
    <button onclick="resetTab('wb')">{reset_tab}</button></div>
  <div id=pane_effect class=pane><div id=sl_effect></div>
    <button onclick="resetTab('effect')">{reset_tab}</button></div>
  <div id=pane_metadata class=pane><table id=exif style="font-size:11px;
    border-collapse:collapse;width:100%"></table></div>
  <div id=curvebox style="display:none">
    <canvas id=curve width=256 height=160></canvas>
    <div style="font-size:11px;color:#888">click: add / drag: move /
      dblclick or double-tap: remove</div>
    <button onclick="resetTab(curCurve)">{reset_tab}</button>
  </div>
  <div style="margin-top:6px"><b>{masks}</b>
    <select id=masksel onchange="switchMask()"><option>main</option></select>
    <button id=maskadd onclick="toggleMaskAdd()">{add_mask}</button>
    <label style="font-size:11px"><input type=checkbox id=smartsel checked>{smart_select}</label>
    <button onclick="maskOp('invert')">{invert_mask}</button>
    <button onclick="maskOp('remove')">{remove_mask}</button>
    <label>{mask_range}: <span id=v_mask_range>0</span>
      <input type=range id=s_mask_range min=0 max=1 step=0.01 value=0></label>
  </div>
  <div style="margin-top:4px"><b>{crop}</b>
    <button id=cropbtn onclick="toggleCrop()">{crop}</button>
    <button onclick="clearCrop()">{clear_crop}</button>
  </div>
  <div style="font-size:11px;color:#888">hold preview: compare original;
    with add-mask armed, click selects by color; with crop armed, drag a
    rectangle</div>
  <button onclick="resetAll()">{reset}</button>
  <button onclick="savePreset()">{save_preset}</button>
  <button onclick="document.getElementById('fpreset').click()">{load_preset}</button>
  <input id=fpreset type=file style="display:none" accept=".json">
  <details><summary>{settings}</summary>
    <label>{language}
      <select id=locale onchange="saveSettings()">
        <option value=en>English</option><option value=ja>日本語</option>
      </select></label>
    <label>{preview_size}
      <input id=uiPreview type=number min=500 max=2000 onchange="saveSettings()"></label>
    <label>{drag_preview_size}
      <input id=dragPreview type=number min=100 max=800 onchange="saveSettings()"></label>
  </details>
</div>
<div id=main><div id=pwrap><img id=preview src="/preview?level=mid">
  <div id=croprect></div></div></div>
<script>
const SLIDERS=[["exposure",-6,6,0.05],["contrast",-100,100,1],["shadow",-100,100,1],
 ["highlight",-100,100,1],["black",-100,100,1],["white",-100,100,1],
 ["wb_temperature",-100,100,1],["wb_tint",-100,100,1],["vignette",-100,100,1],
 ["lens_distortion",-100,100,1],["sharpness",0,100,1]];
const LABELS={labels_json};
const EXIF_LABELS={exif_labels_json};
const state={{}};
// Slider-to-tab layout per the reference edit panel (web/index.html:43-120:
// tone / WB / effect panes; curves get their own tabs below).
const TAB_SLIDERS={{tone:['exposure','contrast','shadow','highlight','black','white'],
  wb:['wb_temperature','wb_tint'],
  effect:['vignette','lens_distortion','sharpness']}};
function tabFor(n){{
  for(const t in TAB_SLIDERS) if(TAB_SLIDERS[t].includes(n)) return t;
  return 'tone';
}}
for(const [name,lo,hi,st] of SLIDERS){{
  state[name]=0;
  const box=document.getElementById('sl_'+tabFor(name));
  box.insertAdjacentHTML('beforeend',
   `<label>${{LABELS[name]||name}}: <span id=v_${{name}}>0</span>
    <input type=range id=s_${{name}} min=${{lo}} max=${{hi}} step=${{st}} value=0></label>`);
  const el=document.getElementById('s_'+name);
  el.oninput=()=>{{state[name]=parseFloat(el.value);
    document.getElementById('v_'+name).textContent=el.value;push('low');}};
  el.onchange=()=>{{push('mid');}};
}}
// Mask binarization threshold (lib.rs:481-499: applied when a mask is
// ADDED, like the reference).
{{
  const el=document.getElementById('s_mask_range');
  el.oninput=()=>{{state.mask_range=parseFloat(el.value);
    document.getElementById('v_mask_range').textContent=el.value;}};
  el.onchange=()=>{{push('mid');}};
}}
// ---- curve editor (tone_curve_editor.ts analog) ----
const CURVE_DEFAULTS={{brightness:[[0,0],[65535,65535]],hue:[[0,0],[65535,65535]],
  saturation:[[0,32767],[65535,32767]],lightness:[[0,32767],[65535,32767]]}};
const curves={{}};
for(const k in CURVE_DEFAULTS) curves[k]=CURVE_DEFAULTS[k].map(q=>q.slice());
let curCurve='brightness', dragIdx=-1;
const cc=document.getElementById('curve'), ctx=cc.getContext('2d');
// ---- tabs (web/index.html tab-container analog) ----
const CURVE_TABS=new Set(['brightness','hue','saturation','lightness']);
function switchTab(name){{
  document.querySelectorAll('#tabhdr button').forEach(b=>
    b.classList.toggle('active',b.dataset.tab===name));
  document.querySelectorAll('.pane').forEach(p=>
    p.classList.toggle('active',p.id==='pane_'+name));
  const cb=document.getElementById('curvebox');
  if(CURVE_TABS.has(name)){{
    document.getElementById('pane_'+name).appendChild(cb);
    cb.style.display='block';curCurve=name;drawCurve();
  }} else cb.style.display='none';
}}
document.querySelectorAll('#tabhdr button').forEach(b=>
  b.onclick=()=>switchTab(b.dataset.tab));
function resetTab(name){{
  // Per-tab reset (the reference's reset-<tab>-button).
  if(CURVE_TABS.has(name)){{
    curves[name]=CURVE_DEFAULTS[name].map(q=>q.slice());
    drawCurve();sendCurves('mid');return;
  }}
  // Derive the reset set from the pane's actual sliders so pane
  // contents and reset targets can never diverge.
  document.querySelectorAll('#pane_'+name+' input[type=range]').forEach(el=>{{
    const n=el.id.replace(/^s_/,'');
    state[n]=0;el.value=0;
    const v=document.getElementById('v_'+n);
    if(v)v.textContent='0';
  }});
  push('mid');
}}
function toPx(p){{return [p[0]/65535*255, 159-p[1]/65535*159];}}
function fromPx(x,y){{return [Math.round(x/255*65535), Math.round((159-y)/159*65535)];}}
function pchipSample(pts,xs){{
  const n=pts.length, X=pts.map(p=>p[0]), Y=pts.map(p=>p[1]);
  if(n===1) return xs.map(_=>Y[0]);
  const h=[],d=[];
  for(let i=0;i<n-1;i++){{h.push(X[i+1]-X[i]);d.push((Y[i+1]-Y[i])/(X[i+1]-X[i]));}}
  const m=[d[0]];
  for(let i=1;i<n-1;i++){{
    if(d[i-1]*d[i]<=0)m.push(0);
    else{{const w1=2*h[i]+h[i-1],w2=h[i]+2*h[i-1];m.push((w1+w2)/(w1/d[i-1]+w2/d[i]));}}
  }}
  m.push(d[n-2]);
  return xs.map(x=>{{
    if(x<=X[0])return Y[0]; if(x>=X[n-1])return Y[n-1];
    let i=0; while(i<n-2&&X[i+1]<x)i++;
    const t=(x-X[i])/h[i],t2=t*t,t3=t2*t;
    return (2*t3-3*t2+1)*Y[i]+(t3-2*t2+t)*h[i]*m[i]
          +(-2*t3+3*t2)*Y[i+1]+(t3-t2)*h[i]*m[i+1];
  }});
}}
let lastHist=null;
function hueGradient(){{
  // OKLCH-hue axis backdrop for the hue/sat/light curves (the reference
  // widget's per-curve PNG backgrounds, tone_curve_editor.ts).
  const g=ctx.createLinearGradient(0,0,256,0);
  for(let i=0;i<=12;i++)g.addColorStop(i/12,`hsl(${{i*30}},70%,45%)`);
  return g;
}}
function drawCurve(){{
  ctx.clearRect(0,0,256,160);
  if(curCurve!=='brightness'){{
    ctx.globalAlpha=0.25;
    ctx.fillStyle=hueGradient();
    ctx.fillRect(0,0,256,160);
    ctx.globalAlpha=1.0;
  }}
  // Histogram overlay behind the brightness curve
  // (raw_photo_forge.py:236-257 draws RGB+luma behind the tone widget).
  if(curCurve==='brightness'&&lastHist){{
    const colors=['rgba(255,85,85,.35)','rgba(85,255,85,.35)',
                  'rgba(85,153,255,.35)','rgba(204,204,204,.45)'];
    const m=Math.max(1,...lastHist.flat());
    lastHist.forEach((row,ci)=>{{
      ctx.strokeStyle=colors[ci];ctx.beginPath();
      row.forEach((v,i)=>{{const y=159-150*v/m;
        i?ctx.lineTo(i,y):ctx.moveTo(i,y);}});
      ctx.stroke();}});
  }}
  ctx.strokeStyle='#444';
  ctx.strokeRect(0,0,256,160);
  const gain=(curCurve==='saturation'||curCurve==='lightness');
  if(gain){{  // display domain [0,2], neutral gain line at 1.0 (=32767.5)
    ctx.strokeStyle='#555';ctx.setLineDash([4,4]);ctx.beginPath();
    ctx.moveTo(0,79.5);ctx.lineTo(256,79.5);ctx.stroke();ctx.setLineDash([]);
  }}
  ctx.fillStyle='#777';ctx.font='9px sans-serif';
  ctx.fillText(gain?'2.0':'1.0',3,10);
  ctx.fillText('0',3,157);
  if(gain)ctx.fillText('1.0',3,77);
  const pts=curves[curCurve];
  const xs=Array.from({{length:128}},(_,i)=>i/127*65535);
  const ys=pchipSample(pts,xs);
  ctx.strokeStyle='#8cf';ctx.beginPath();
  xs.forEach((x,i)=>{{const px=x/65535*255,py=159-Math.min(Math.max(ys[i],0),65535)/65535*159;
    i?ctx.lineTo(px,py):ctx.moveTo(px,py);}});
  ctx.stroke();
  ctx.fillStyle='#fc6';
  for(const p of pts){{const [px,py]=toPx(p);ctx.fillRect(px-3,py-3,6,6);}}
}}
function curvePos(e){{
  const r=cc.getBoundingClientRect();
  return [(e.clientX-r.left)*256/r.width,(e.clientY-r.top)*160/r.height];
}}
cc.onmousedown=e=>{{
  const [x,y]=curvePos(e);const pts=curves[curCurve];
  dragIdx=pts.findIndex(p=>{{const [px,py]=toPx(p);return Math.abs(px-x)<8&&Math.abs(py-y)<8;}});
  if(dragIdx<0){{
    // Clamp new points into the domain and keep x strictly increasing
    // (duplicate x would make the PCHIP slopes Inf/NaN and the server
    // reject the curve).
    const np=fromPx(x,y);
    np[0]=Math.min(Math.max(np[0],0),65535);
    np[1]=Math.min(Math.max(np[1],0),65535);
    if(pts.some(p=>Math.abs(p[0]-np[0])<64))return;
    pts.push(np);pts.sort((a,b)=>a[0]-b[0]);dragIdx=pts.indexOf(np);drawCurve();
  }}
}};
cc.onmousemove=e=>{{
  if(dragIdx<0)return;
  const [x,y]=curvePos(e);const pts=curves[curCurve];
  const lo=dragIdx>0?pts[dragIdx-1][0]+64:0;
  const hi=dragIdx<pts.length-1?pts[dragIdx+1][0]-64:65535;
  const np=fromPx(x,y);
  pts[dragIdx]=[Math.min(Math.max(np[0],lo),hi),Math.min(Math.max(np[1],0),65535)];
  drawCurve();
}};
cc.onmouseup=()=>{{if(dragIdx>=0){{dragIdx=-1;sendCurves('mid');}}}};
function deleteNear(x,y){{
  const pts=curves[curCurve];
  const i=pts.findIndex(p=>{{const [px,py]=toPx(p);return Math.abs(px-x)<8&&Math.abs(py-y)<8;}});
  if(i>=0&&pts.length>2){{pts.splice(i,1);drawCurve();sendCurves('mid');}}
}}
cc.ondblclick=e=>{{const [x,y]=curvePos(e);deleteNear(x,y);}};
// Touch: drag points, double-tap to delete (tone_curve_editor.ts:217-254).
let lastTap=0;
cc.addEventListener('touchstart',e=>{{
  e.preventDefault();
  const t=e.changedTouches[0];
  const now=Date.now();
  if(now-lastTap<300){{
    const [x,y]=curvePos(t);deleteNear(x,y);lastTap=0;return;
  }}
  lastTap=now;
  cc.onmousedown(t);
}},{{passive:false}});
cc.addEventListener('touchmove',e=>{{
  e.preventDefault();cc.onmousemove(e.changedTouches[0]);
}},{{passive:false}});
cc.addEventListener('touchend',e=>{{e.preventDefault();cc.onmouseup();}},
  {{passive:false}});
function sendCurves(level){{
  for(const name in curves) state['curve_'+name]=curves[name];
  push(level);
}}
function loadCurvesFrom(p){{
  // Replace the editor's working points with the target mask's stored
  // curves and drop pending curve_* state so curves edited on one mask
  // are never re-applied to another.
  for(const name in curves){{
    const c=(p.curves||{{}})[name];
    curves[name]=c&&c.x?c.x.map((x,i)=>[x,c.y[i]])
      :CURVE_DEFAULTS[name].map(q=>q.slice());
    delete state['curve_'+name];
  }}
  drawCurve();
}}
// ---- render loop + zoom/pan viewport ----
// Wheel zooms around the cursor, drag pans when zoomed, dblclick resets.
// The server slices the viewport from its cached render (tiled multi-zoom:
// pan/zoom never recomputes the develop stack).
let busy=false,queued=null;
const view={{zoom:1,cx:0.5,cy:0.5}};
function viewRect(){{
  const he=0.5/view.zoom;
  const x0=Math.min(Math.max(view.cx-he,0),1-2*he);
  const y0=Math.min(Math.max(view.cy-he,0),1-2*he);
  view.cx=x0+he;view.cy=y0+he;
  return [x0,y0,x0+2*he,y0+2*he];
}}
function previewURL(level,original){{
  // Zoomed-in still views fetch the FULL-res render for pixel peeping.
  const lv=(view.zoom>=2&&level!=='low')?'full':level;
  let u='/preview?level='+lv+(original?'&original=1':'')+'&t='+Date.now();
  if(view.zoom>1.001)u+='&rect='+viewRect().map(v=>v.toFixed(5)).join(',');
  return u;
}}
function pvRefresh(level,original){{
  document.getElementById('preview').src=previewURL(level,!!original);
}}
async function push(level){{
  if(busy){{queued=level;return;}}
  busy=true;
  try{{
    await fetch('/edit',{{method:'POST',body:JSON.stringify(state)}});
    pvRefresh(level);
    // Drag ticks get a LIVE host-computed histogram (?drag=1) when the
    // server's host-drag path is on (204 = keep the last one); release
    // ticks fetch the exact MID device histogram.
    const hr=await fetch('/histogram'+(level==='low'?'?drag=1':''));
    if(hr.status===200) drawHist(await hr.json());
  }}finally{{
    // Never leave the render loop bricked by one rejected fetch.
    busy=false;
  }}
  if(queued){{const q=queued;queued=null;push(q);}}
}}
function drawHist(h){{
  lastHist=h;
  const c=document.getElementById('hist').getContext('2d');
  c.clearRect(0,0,256,70);
  const colors=['#f55','#5f5','#59f','#ccc'];
  const m=Math.max(1,...h.flat());
  h.forEach((row,ci)=>{{c.strokeStyle=colors[ci];c.beginPath();
    row.forEach((v,i)=>{{const y=70-68*v/m; i?c.lineTo(i,y):c.moveTo(i,y);}});c.stroke();}});
  if(curCurve==='brightness')drawCurve();  // refresh the overlay
}}
async function resetAll(){{
  await fetch('/reset',{{method:'POST'}});
  imgInfo=await (await fetch('/info')).json();  // crop cleared server-side
  // Regional masks are gone server-side: re-target main and reload the
  // dropdown, or every subsequent edit 400s with MaskNotFound.
  state._target='main';
  await loadMasks('main');
  for(const [name] of SLIDERS){{state[name]=0;
    document.getElementById('s_'+name).value=0;
    document.getElementById('v_'+name).textContent='0';}}
  for(const name in curves) curves[name]=CURVE_DEFAULTS[name].map(q=>q.slice());
  for(const k in state) if(k.startsWith('curve_')) delete state[k];
  drawCurve();push('mid');
}}
async function asyncExport(fmt,filename){{
  // Job-based export (server worker thread): the edit loop stays live
  // while a FULL render + fetch runs; the status span tracks the stage.
  const st=document.getElementById('exp_status');
  st.textContent='...';
  try{{
    const r=await fetch('/export/start',{{method:'POST',
      body:JSON.stringify({{fmt:fmt}})}});
    if(!r.ok)throw new Error((await r.json()).error||r.status);
    const job=(await r.json()).job;
    for(;;){{
      const sr=await fetch('/export/status?job='+job);
      const s=await sr.json();
      // A non-OK reply (evicted job, server restart) has no `state`
      // field — without this check the loop would poll forever.
      if(!sr.ok)throw new Error(s.error||sr.status);
      if(s.state==='error')throw new Error(s.error);
      if(s.state==='done'){{break;}}
      st.textContent=s.stage+'...';
      await new Promise(res=>setTimeout(res,300));
    }}
    // An evicted job / restarted server answers 4xx JSON here — that
    // must surface as an error, not download as the image file.
    const rr=await fetch('/export/result?job='+job);
    if(!rr.ok)throw new Error((await rr.json()).error||rr.status);
    const blob=await rr.blob();
    const a=document.createElement('a');
    a.href=URL.createObjectURL(blob);a.download=filename;a.click();
    setTimeout(()=>URL.revokeObjectURL(a.href),10000);
    st.textContent='';
  }}catch(e){{st.textContent='export failed: '+e.message;}}
}}
async function savePreset(){{
  const p=await (await fetch('/preset')).text();
  const a=document.createElement('a');
  a.href=URL.createObjectURL(new Blob([p]));a.download='preset.json';a.click();
}}
async function saveSettings(){{
  await fetch('/settings',{{method:'POST',body:JSON.stringify({{
    locale:document.getElementById('locale').value,
    ui_preview_size:parseInt(document.getElementById('uiPreview').value),
    drag_preview_size:parseInt(document.getElementById('dragPreview').value)}})}});
}}
fetch('/settings').then(r=>r.json()).then(s=>{{
  document.getElementById('locale').value=s.locale;
  document.getElementById('uiPreview').value=s.ui_preview_size;
  document.getElementById('dragPreview').value=s.drag_preview_size;}});
function fillExif(e){{
  // Two-column metadata table (web/index.html metadata-table analog);
  // textContent per cell keeps tag values from injecting markup.
  const t=document.getElementById('exif');t.innerHTML='';
  for(const [k,v] of Object.entries(e)){{
    const tr=t.insertRow();
    const name=tr.insertCell(), val=tr.insertCell();
    name.textContent=EXIF_LABELS[k]||k; val.textContent=v;
    name.style.cssText='color:#999;padding:2px 8px 2px 0;border-bottom:1px solid #333';
    val.style.cssText='padding:2px 0;border-bottom:1px solid #333';
  }}
  markLens(imgInfo);
}}
function markLens(i){{
  // Lens-correction provenance row: a bundled approximate profile must
  // be visibly distinguishable from calibrated lensfun data.
  if(!i||!i.lens_profile)return;
  const t=document.getElementById('exif');
  let tr=document.getElementById('lensrow');
  if(!tr){{tr=t.insertRow(0);tr.id='lensrow';tr.insertCell();tr.insertCell();}}
  tr.cells[0].textContent='Lens correction';
  tr.cells[1].textContent=i.lens_profile+(i.lens_profile_approximate?
    ' — APPROXIMATE bundled profile (not calibrated data)':'');
  tr.cells[0].style.cssText='color:#999;padding:2px 8px 2px 0;border-bottom:1px solid #333';
  tr.cells[1].style.cssText='padding:2px 0;border-bottom:1px solid #333'+
    (i.lens_profile_approximate?';color:#cfa342':'');
}}
fetch('/exif').then(r=>r.json()).then(fillExif);
// ---- masks + compare-to-original ----
let maskAddMode=false, imgInfo=null, maskCounter=0;
fetch('/info').then(r=>r.json()).then(i=>{{imgInfo=i;markLens(i);}});
let maskPts=[], maskLabs=[], ptMarkers=[];
function clearPtMarkers(){{
  for(const m of ptMarkers)m.remove();
  ptMarkers=[];maskPts=[];maskLabs=[];
}}
function addPtMarker(px,py,label){{
  const d=document.createElement('div');
  d.style.cssText='position:absolute;width:10px;height:10px;border-radius:50%;'+
    'border:2px solid #fff;pointer-events:none;transform:translate(-50%,-50%);'+
    'background:'+(label?'#2e7dd1':'#d13b2e');
  d.style.left=px+'px';d.style.top=py+'px';
  document.getElementById('pwrap').appendChild(d);
  ptMarkers.push(d);
}}
function toggleMaskAdd(){{
  maskAddMode=!maskAddMode;
  if(!maskAddMode)clearPtMarkers();
  document.getElementById('maskadd').style.background=maskAddMode?'#675527':'#333';
}}
async function loadMasks(keep){{
  const names=await (await fetch('/masks')).json();
  const sel=document.getElementById('masksel');
  sel.innerHTML=names.map(n=>`<option>${{n}}</option>`).join('');
  sel.value=names.includes(keep)?keep:'main';
  state._target=sel.value;
}}
// vignette/lens-distortion/sharpness act on the whole frame (main only,
// wgsl:270-276): never copy them from a regional mask's (zero) params, or
// the next push would wipe the user's global edits.
const GLOBAL_ONLY=new Set(['vignette','lens_distortion','sharpness']);
async function switchMask(){{
  const sel=document.getElementById('masksel');
  state._target=sel.value;
  const p=await (await fetch('/params?mask='+encodeURIComponent(sel.value))).json();
  for(const [name] of SLIDERS){{
    if(name in p&&!GLOBAL_ONLY.has(name)){{state[name]=p[name];
      document.getElementById('s_'+name).value=p[name];
      document.getElementById('v_'+name).textContent=p[name];}}
  }}
  loadCurvesFrom(p);
}}
async function maskOp(op){{
  const sel=document.getElementById('masksel');
  if(sel.value==='main')return;
  await fetch('/mask/'+op,{{method:'POST',body:JSON.stringify({{name:sel.value}})}});
  await loadMasks(op==='remove'?'main':sel.value);
  push('mid');
}}
// ---- file open / preset load (web/main.ts:652-695 loadImage dialog,
// raw_photo_forge.py:2259-2341 preset load) ----
document.getElementById('fopen').onchange=async e=>{{
  const f=e.target.files[0];
  if(!f)return;
  const r=await fetch('/open?name='+encodeURIComponent(f.name),
    {{method:'POST',body:await f.arrayBuffer()}});
  if(r.ok){{location.reload();}}
  else alert((await r.json()).error);
}};
document.getElementById('fpreset').onchange=async e=>{{
  const f=e.target.files[0];
  if(!f)return;
  const r=await fetch('/preset',{{method:'POST',body:await f.text()}});
  if(!r.ok){{alert((await r.json()).error);return;}}
  const p=await (await fetch('/params?mask=main')).json();
  for(const [name] of SLIDERS){{
    if(name in p){{state[name]=p[name];
      document.getElementById('s_'+name).value=p[name];
      document.getElementById('v_'+name).textContent=p[name];}}
  }}
  loadCurvesFrom(p);
  imgInfo=await (await fetch('/info')).json();
  push('mid');
}};
// ---- crop drag-rect (v1 crop, editor.py:358-366) ----
let cropMode=false, cropStart=null;
const cropDiv=document.getElementById('croprect');
function toggleCrop(){{
  cropMode=!cropMode;
  document.getElementById('cropbtn').className=cropMode?'armed':'';
}}
async function clearCrop(){{
  await fetch('/crop',{{method:'POST',body:JSON.stringify({{clear:true}})}});
  imgInfo=await (await fetch('/info')).json();
  push('mid');
}}
function cropPx(e){{
  const r=pv.getBoundingClientRect();
  return [e.clientX-r.left, e.clientY-r.top, r];
}}
async function finishCrop(e){{
  const [x1,y1,r]=cropPx(e);
  const [x0,y0]=cropStart;
  cropStart=null;
  cropDiv.style.display='none';
  if(Math.abs(x1-x0)<5||Math.abs(y1-y0)<5)return;
  // Display coords -> FULL-image coords: through the zoom viewport, then
  // the current crop region's extent and origin.
  const cur=imgInfo.crop||[0,0,imgInfo.shape[1],imgInfo.shape[0]];
  const [vx0,vy0,vx1,vy1]=viewRect();
  const fx=p=>vx0+(p/r.width)*(vx1-vx0);
  const fy=p=>vy0+(p/r.height)*(vy1-vy0);
  await fetch('/crop',{{method:'POST',body:JSON.stringify({{
    x0:Math.round(cur[0]+fx(Math.min(x0,x1))*(cur[2]-cur[0])),
    y0:Math.round(cur[1]+fy(Math.min(y0,y1))*(cur[3]-cur[1])),
    x1:Math.round(cur[0]+fx(Math.max(x0,x1))*(cur[2]-cur[0])),
    y1:Math.round(cur[1]+fy(Math.max(y0,y1))*(cur[3]-cur[1]))}})}});
  imgInfo=await (await fetch('/info')).json();
  view.zoom=1;view.cx=view.cy=0.5;
  toggleCrop();
  push('mid');
}}
const pv=document.getElementById('preview');
let panStart=null,panMoved=false,lastPanFetch=0;
pv.onwheel=e=>{{
  e.preventDefault();
  const r=pv.getBoundingClientRect();
  const fx=(e.clientX-r.left)/r.width, fy=(e.clientY-r.top)/r.height;
  const [x0,y0]=viewRect();
  const px=x0+fx/view.zoom, py=y0+fy/view.zoom;  // point under cursor
  view.zoom=Math.min(Math.max(view.zoom*(e.deltaY<0?1.25:0.8),1),16);
  view.cx=px-fx/view.zoom+0.5/view.zoom;
  view.cy=py-fy/view.zoom+0.5/view.zoom;
  if(view.zoom<=1.001){{view.zoom=1;view.cx=view.cy=0.5;}}
  pvRefresh('mid');
}};
pv.ondblclick=()=>{{view.zoom=1;view.cx=view.cy=0.5;pvRefresh('mid');}};
pv.onmousedown=async e=>{{
  if(cropMode){{
    e.preventDefault();
    cropStart=cropPx(e);
    cropDiv.style.display='block';
    cropDiv.style.left=cropStart[0]+'px';cropDiv.style.top=cropStart[1]+'px';
    cropDiv.style.width='0';cropDiv.style.height='0';
  }} else if(maskAddMode&&imgInfo){{
    const r=pv.getBoundingClientRect();
    const cur=imgInfo.crop||[0,0,imgInfo.shape[1],imgInfo.shape[0]];
    const [vx0,vy0,vx1,vy1]=viewRect();
    const fx=vx0+(e.clientX-r.left)/r.width*(vx1-vx0);
    const fy=vy0+(e.clientY-r.top)/r.height*(vy1-vy0);
    const x=Math.round(cur[0]+fx*(cur[2]-cur[0]));
    const y=Math.round(cur[1]+fy*(cur[3]-cur[1]));
    if(e.shiftKey){{
      // shift-click accumulates a labeled point: include, or EXCLUDE
      // with ctrl/cmd held (v1 predictor labels; carve-out rule).
      const lab=(e.ctrlKey||e.metaKey)?0:1;
      maskPts.push([x,y]);maskLabs.push(lab);
      addPtMarker(e.clientX-r.left,e.clientY-r.top,lab);
      return;
    }}
    const name='mask'+(++maskCounter);
    const smart=document.getElementById('smartsel').checked;
    let payload;
    if(maskPts.length){{
      // Plain click submits the accumulated labeled set + this point.
      const pts=maskPts.concat([[x,y]]), labs=maskLabs.concat([1]);
      payload=smart?{{name:name,points:pts,labels:labs,smart:true,tolerance:0.15}}
                   :{{name:name,points:pts,labels:labs,tolerance:0.12}};
    }} else {{
      payload=smart?{{name:name,point:[x,y],smart:true,tolerance:0.15}}
                   :{{name:name,point:[x,y],tolerance:0.12}};
    }}
    clearPtMarkers();
    await fetch('/mask/add',{{method:'POST',body:JSON.stringify(payload)}});
    await loadMasks(name);
    switchMask();
    toggleMaskAdd();
    push('mid');
  }} else if(view.zoom>1){{
    e.preventDefault();
    panStart=[e.clientX,e.clientY,view.cx,view.cy];
    panMoved=false;
  }} else {{
    pvRefresh('mid',true);  // hold to compare with the original
  }}
}};
pv.onmousemove=e=>{{
  if(cropStart){{
    const [x,y]=cropPx(e);
    cropDiv.style.left=Math.min(x,cropStart[0])+'px';
    cropDiv.style.top=Math.min(y,cropStart[1])+'px';
    cropDiv.style.width=Math.abs(x-cropStart[0])+'px';
    cropDiv.style.height=Math.abs(y-cropStart[1])+'px';
    return;
  }}
  if(!panStart)return;
  const r=pv.getBoundingClientRect();
  view.cx=panStart[2]-(e.clientX-panStart[0])/r.width/view.zoom;
  view.cy=panStart[3]-(e.clientY-panStart[1])/r.height/view.zoom;
  panMoved=true;
  if(Date.now()-lastPanFetch>150){{lastPanFetch=Date.now();pvRefresh('low');}}
}};
pv.onmouseup=pv.onmouseleave=e=>{{
  if(cropStart){{finishCrop(e);return;}}
  if(panStart){{panStart=null;if(panMoved)pvRefresh('mid');return;}}
  if(!maskAddMode&&!cropMode)pvRefresh('mid');
}};
pv.ondragstart=()=>false;
// ---- async-open poller: while the device phase of a just-opened file
// compiles (server /open/status not ready), the preview/histogram are
// host-side instant stand-ins; poll until ready, then re-post the full
// client state so any sliders moved meanwhile take effect.
let wasOpening=false;
async function pollReady(){{
  try{{
    const s=await (await fetch('/open/status')).json();
    // Own span: the 2.5 s poll must not clobber live export progress
    // text (export jobs stay reachable through the era).
    const st=document.getElementById('open_status');
    if(!s.ready){{
      wasOpening=true;
      st.textContent=LABELS.opening||'processing on device…';
      setTimeout(pollReady,2500);
      return;
    }}
    if(wasOpening){{
      // Ready again: either the new session landed, or the device
      // phase failed and the server rolled back to the previous
      // session (s.error says why) — both are fully interactive.
      wasOpening=false;
      st.textContent=s.error?('open failed: '+s.error):'';
      imgInfo=await (await fetch('/info')).json();
      markLens(imgInfo);
      push('mid');  // real render with the full current client state
    }}
  }}catch(e){{setTimeout(pollReady,4000);}}
}}
pollReady();
loadMasks('main');
drawCurve();push('mid');
</script></body></html>"""


class EditorApp:
    """The server's model object: one PhotoEditor + its lock + settings."""

    def __init__(self, editor: PhotoEditor | None,
                 settings: Settings | None = None,
                 settings_path: str | None = None, segmenter=None,
                 prewarm: bool = True, host_drag: bool = True,
                 lens_correct=False, lens_db_paths=None, device=None):
        # The device every session lives on, resolved once: the card
        # unless the caller asks for the CPU (no silent CPU fallback).
        self.device = (editor.device if editor is not None and device is None
                       else resolve_device(device))
        # serve --lens-correct: auto-resolve each opened file's EXIF
        # against the lens DB and apply the profile at the device phase
        # (the v1 lensfun flow PhotoEditor.open implements for the CLI).
        # Truthy values: True/"auto" or "calibrated-only" (skip
        # approximate-provenance profiles).
        self.lens_correct = lens_correct
        self.lens_db_paths = lens_db_paths
        # None until the first open lands (instant server startup: serve()
        # begins listening during the initial file's device phase; the
        # era endpoints carry the UI until then).
        self.editor = editor
        self.prewarm = prewarm  # warm the libraries and levels on /open
        # Host-rendered LOW drag previews (see preview_jpeg). (key,
        # linear, masks) cache below.
        self.host_drag = host_drag
        self._hostdrag_cache = None
        self._hostdrag_warned = False
        self.lock = threading.Lock()
        self.settings = settings or Settings.load(settings_path)
        self.settings_path = settings_path
        # Optional external promptable-segmentation adapter for AI masks
        # (engine/segmenter.py); /mask/add uses it when {"model": true}.
        self.segmenter = segmenter
        # Async export jobs (v1 runs exports on a worker thread with a
        # progress dialog, raw_photo_forge.py:2180-2257): job id ->
        # mutable status dict. Only the last few are retained.
        self.export_jobs: dict[str, dict] = {}
        self._export_seq = 0
        # Async open (engine.instant design): while a just-opened file's
        # device phase (upload, develop, the first renders) runs in a
        # background thread, `opening` holds the
        # host-side session the UI is served from: an instant preview
        # JPEG, its histogram, shape and EXIF. `opening is not None` is
        # the instant era: previews/histograms come from it, editor-state
        # endpoints answer 409 (the client keeps full slider state and
        # re-posts it whole once ready, so nothing is lost).
        self.opening: dict | None = None
        self._open_seq = 0
        # Device-phase failure of the MOST RECENT open (reported by
        # /open/status after the era ends; a new /open clears it). The
        # previous session is never replaced until success, so a failed
        # open rolls back to a fully usable editor.
        self.last_open_error: str | None = None
        # Signaled when the open's device phase lands (tests/benches wait
        # on it; the UI polls /open/status instead).
        self.device_ready = threading.Event()
        self.device_ready.set()

    def _auto_lens(self, ed: PhotoEditor) -> None:
        """Resolve + apply a lens profile from the session's EXIF when
        the server runs with --lens-correct. Best-effort by contract: an
        unreadable DB or unmatched lens must never fail an open (the CLI
        flow has the same posture — no match is a silent no-op, recorded
        as applied_lens_profile=None in /info)."""
        if not self.lens_correct:
            return
        try:
            from ..io.lensdb import LensDatabase

            prof = LensDatabase.load(
                self.lens_db_paths).profile_from_exif(
                    ed.exif,
                    calibrated_only=(self.lens_correct
                                     == "calibrated-only"))
            if prof is not None:
                ed.apply_lens_profile(prof)
                # The record is the caller's job (PhotoEditor.open does
                # the same): apply_lens_profile is also the manual-apply
                # API and must not claim auto-resolution.
                ed.applied_lens_profile = prof.name
                ed.applied_lens_approximate = bool(prof.approximate)
        except Exception as e:  # noqa: BLE001 — best-effort correction
            print(f"lens-correct skipped: {e}", file=sys.stderr)

    def start_open(self, raw_body: bytes, name: str) -> dict:
        """Host-decode an uploaded file and kick off the device phase.

        File-content errors raise HERE (synchronously -> a 400 with the
        parse error, exactly like the old blocking open). When the decode
        yields an instant preview, the upload and first renders continue on a
        daemon thread and the response returns immediately; otherwise
        falls back to the blocking open. The session lands on
        ``self.device``. ``name`` may be empty/None (no
        ?name= given): the format is then sniffed from the body's magic
        (a DNG body without a filename used to be force-decoded as
        JPEG)."""
        fmt = (image_io.format_for_path(name) if name
               else image_io.format_for_bytes(raw_body))
        kwargs = dict(mid_long_edge=self.settings.ui_preview_size,
                      low_long_edge=self.settings.drag_preview_size,
                      device=self.device)
        ho = PhotoEditor.open_host(
            raw_body, fmt, mid_long_edge=self.settings.ui_preview_size)
        self.last_open_error = None
        if ho.instant is None:
            # No host pixels to show (exotic mode): keep today's blocking
            # behavior rather than an instant era with a blank frame.
            ed = PhotoEditor.from_host(ho, **kwargs)
            self._auto_lens(ed)
            self.editor = ed
            self._hostdrag_cache = None  # never serve the old session
            self.opening = None
            self.device_ready.set()
            if self.prewarm:
                from ..engine.prewarm import warm_async

                warm_async(self.lock, editor=ed)
            return {"ok": True, "instant": False,
                    "opened_from_preview": ed.opened_from_preview}

        from ..engine import instant as _instant

        self._open_seq += 1
        seq = self._open_seq
        self.opening = {
            "seq": seq,
            "jpeg": _instant.encode_instant_jpeg(ho.instant),
            "hist": _instant.instant_histogram(ho.instant).tolist(),
            "shape": list(ho.shape),
            "exif": {k: v for k, v in ho.exif.items()
                     if k != "_exif_bytes"},
            "opened_from_preview": ho.preview_reason,
            "pixels": ho.instant,
            # Live era edits (engine.hostdev): the small linear planes
            # edits render from, the current EditParameters (None =
            # pristine, serve the decode JPEG above), the raw /edit body
            # to replay onto the device session at swap, the era crop
            # rect (FULL coords), and the lazily-built (jpeg, hist)
            # render cache.
            "linear": ho.instant_linear,
            "linear_low": None,  # built lazily on the first low request
            "params": None,
            "masks": [],  # era regional masks: {name, logits, data, params}
            "replay": [],
            "applied": 0,  # replay items the finisher already applied
            "crop": None,
            "render": None,
            "render_low": None,
        }
        self.device_ready.clear()
        threading.Thread(
            target=self._finish_open, args=(ho, seq, kwargs),
            name="rpf-open", daemon=True,
        ).start()
        return {"ok": True, "instant": True,
                "opened_from_preview": ho.preview_reason}

    def _finish_open(self, ho, seq: int, kwargs: dict) -> None:
        """Device phase of an async open (background thread): upload,
        render + cache the first MID preview and histogram on a session
        nobody else can see yet, then swap it in under the lock."""
        try:
            ed = PhotoEditor.from_host(ho, **kwargs)
            # Before the first renders so they cover the corrected base
            # the session will actually serve.
            self._auto_lens(ed)
            ed.apply(MID)      # the first render lands off the request path
            ed.histogram(MID)
        except Exception as e:  # noqa: BLE001 — surfaced via /open/status
            with self.lock:
                if self.opening is not None and self.opening["seq"] == seq:
                    # Roll back: end the instant era (the previous session
                    # was never replaced and stays fully usable) and
                    # surface the failure via /open/status. device_ready
                    # is set under the same lock and ONLY when this open
                    # still owns the era — a superseded open must not
                    # set the event a newer /open just cleared.
                    self.opening = None
                    self.last_open_error = str(e)
                    self.device_ready.set()
            return
        # Replay edits made during the era onto the device session BEFORE
        # it becomes visible — era edits persist even for API clients
        # that don't re-post state on ready. Items are applied OUTSIDE
        # the app lock (a model-mask replay runs an external segmenter; a
        # smart-mask replay runs a flood — holding the lock
        # would freeze every request, including /open/status, at swap
        # time). The loop re-checks under the lock for items that arrived
        # while replaying (op["applied"] gates era_edit's collapse so an
        # already-applied trailing edit is never popped) and only swaps
        # when the list is drained.
        while True:
            with self.lock:
                op = self.opening
                if op is None or op["seq"] != seq:
                    return  # superseded by a newer /open
                pending = list(op["replay"][op["applied"]:])
                # CLAIM the items before leaving the lock: era_edit's
                # trailing-collapse gate reads op["applied"], and an item
                # being applied right now must not be popped-and-replaced
                # (the replacement would land inside the already-counted
                # region and never replay).
                op["applied"] += len(pending)
                if not pending:
                    # Drained: settle the final crop state and swap.
                    # Per-item isolation throughout: one rejected item
                    # (e.g. a preset whose crop was saved from a larger
                    # image) must not void the items around it.
                    try:
                        if op["crop"] is not None:
                            ed.set_crop(*op["crop"])
                        elif op["replay"]:
                            ed.clear_crop()  # a preset may have set one;
                            #                  the era ended with none
                    except Exception:  # noqa: BLE001
                        pass
                    self.editor = ed
                    self._hostdrag_cache = None  # never serve the old session
                    self.opening = None
                    # Inside the lock: a new /open arriving after the
                    # swap clears the event for ITS era; setting it out
                    # here would falsely mark that newer open ready.
                    self.device_ready.set()
                    break
            for kind, body in pending:  # outside the lock
                try:
                    self._replay_item(ed, kind, body)
                except Exception:  # noqa: BLE001 — stand-in state only
                    pass
        if self.prewarm:
            # After the swap — unconditionally, not per replay item: the
            # common no-edits-during-open case must still warm the LOW
            # drag level, or the first slider drag pays its first render.
            from ..engine.prewarm import warm_async

            warm_async(self.lock, editor=ed)

    def _replay_item(self, ed: PhotoEditor, kind: str, body) -> None:
        """Apply one era (edit|preset|mask_*) item to the not-yet-visible
        device session. Selections re-run on the REAL render at full
        resolution — the era's instant-resolution result was the
        stand-in."""
        if kind == "edit":
            self.apply_state(body, editor=ed)
        elif kind == "preset":  # full fidelity: masks + crop
            ed.load_preset_json(json.dumps(body))
        elif kind == "mask_add":
            pt = tuple(body["point"]) if "point" in body else None
            pts = ([tuple(q) for q in body["points"]]
                   if "points" in body else None)
            labs = body.get("labels")
            if body.get("model"):
                ed.add_model_mask(
                    body["name"], pt, self.segmenter,
                    points_xy=pts, labels=labs)
            elif body.get("smart"):
                ed.add_smart_mask(
                    body["name"], pt,
                    float(body.get("tolerance", 0.15)),
                    float(body.get("edge_weight", 12.0)),
                    points_xy=pts, labels=labs)
            elif pt is not None or pts is not None:
                ed.add_similarity_mask(
                    body["name"], pt,
                    float(body.get("tolerance", 0.1)),
                    float(body.get("sigma", 0.0)),
                    points_xy=pts, labels=labs)
            else:
                ed.add_mask(body["name"],
                            np.asarray(body["data"], dtype=np.float32))
        elif kind == "mask_remove":
            ed.remove_mask(body["name"])
        elif kind == "mask_invert":
            ed.invert_mask(body["name"])
        elif kind == "reset":
            ed.reset()
            ed.clear_crop()

    def open_status(self) -> dict:
        op = self.opening
        if op is None:
            return {"ready": True, "error": self.last_open_error}
        return {"ready": False, "error": None,
                "opened_from_preview": op["opened_from_preview"]}

    # -- live edits during the instant era (engine.hostdev) --------------
    @staticmethod
    def _era_find_mask(op: dict, name: str) -> dict:
        for m in op["masks"]:
            if m["name"] == name:
                return m
        raise ValueError(f"unknown mask {name!r}")

    def era_edit(self, body: dict) -> None:
        """/edit while the device phase runs: validate exactly like
        apply_state, stash the EditParameters for the host renderer, and
        remember the body to replay onto the device session at swap —
        era edits are never lost, with or without a well-behaved client."""
        from ..core.params import EditParameters

        op = self.opening
        target = body.get("_target") or "main"
        scratch = self._state_to_params(body)
        prev_main = op["params"] or EditParameters()
        if target == "main":
            # Globals follow apply_state: applied only when the request
            # carries them, preserved otherwise.
            if "vignette" not in body:
                scratch.vignette = prev_main.vignette
            if "lens_distortion" not in body:
                scratch.lens_distortion = prev_main.lens_distortion
            if "sharpness" not in body:
                scratch.sharpness = prev_main.sharpness
            scratch.mask_range = prev_main.mask_range
            op["params"] = scratch
        else:
            m = self._era_find_mask(op, target)
            # Full-state for the targeted mask; globals (if present) go
            # to main, like apply_state.
            m["params"] = scratch
            main = prev_main
            if "vignette" in body:
                main.set_vignette(int(body["vignette"]))
            if "lens_distortion" in body:
                main.set_lens_distortion(int(body["lens_distortion"]))
            if "sharpness" in body:
                main.set_sharpness(int(body["sharpness"]))
            op["params"] = main
        if "mask_range" in body:
            mr = float(body["mask_range"])
            op["params"].mask_range = mr
            for m in op["masks"]:
                if m["logits"] is not None:
                    m["data"] = (m["logits"] >= mr).astype(np.float32)
        # /edit is full-state: a trailing same-target edit replaces the
        # previous one (never an interleaved preset or mask op, and
        # never an item the swap finisher has already applied).
        if len(op["replay"]) > op["applied"] and \
                op["replay"][-1][0] == "edit" and \
                (op["replay"][-1][1].get("_target") or "main") == target:
            op["replay"].pop()
        op["replay"].append(("edit", body))
        op["render"] = op["render_low"] = None  # re-render lazily

    def era_mask_add(self, body: dict) -> None:
        """/mask/add during the era — similarity and data-array masks
        only (smart/model selections need the device; they stay 409).
        The selection runs on the era's RENDERED image like
        add_similarity_mask, at instant resolution; the swap replays the
        original request on the real session."""
        from ..core.params import EditParameters
        from ..engine import hostdev
        from ..engine import instant as _instant

        self.check_keys(
            body,
            frozenset({"name", "point", "points", "labels", "data",
                       "model", "smart",
                       "tolerance", "edge_weight", "sigma"}),
            "/mask/add")
        op = self.opening
        name = body.get("name")
        if not name or not isinstance(name, str):
            raise ValueError("mask name must be non-empty")
        if name == "main" or any(m["name"] == name for m in op["masks"]):
            raise ValueError(f"mask name {name!r} already exists")
        ih, iw = op["linear"].shape[1], op["linear"].shape[2]
        fh, fw = op["shape"]
        if "point" in body or "points" in body:
            raw_pts = ([body["point"]] if "point" in body
                       else list(body["points"]))
            labs = [1 if int(v) else 0 for v in
                    (body.get("labels") or [1] * len(raw_pts))]
            if len(labs) != len(raw_pts) or not raw_pts:
                raise ValueError(
                    f"{len(labs)} labels for {len(raw_pts)} points")
            # Era-resolution (y, x) coordinates, clamped like the
            # single-point path.
            pts_yx = [
                (min(ih - 1, max(0, int(float(y) * ih / fh))),
                 min(iw - 1, max(0, int(float(x) * iw / fw))))
                for x, y in raw_pts]
            py, px = pts_yx[0]
            plist, marr = self._era_plist_masks(op, (ih, iw))
            # The prompt samples the RENDERED image as u8 (v1 feeds the
            # predictor its display buffer, raw_photo_forge.py:2409-2411)
            # — so render straight to u8 on the fused native path instead
            # of a full-precision numpy develop quantized afterwards.
            base_u8 = hostdev.render_u8_hwc(op["linear"], plist, marr)
            if body.get("model"):
                # The external segmenter is a HOST process — it only
                # needs a render, and the era has one. Same operator-
                # trust rule as the normal handler: only the launch-
                # configured adapter runs.
                if body["model"] is not True and body["model"] != "default":
                    raise ValueError(
                        "segmenter specs are not accepted over HTTP; "
                        "configure one with --segmenter at launch and "
                        'pass {"model": true}')
                if self.segmenter is None:
                    raise ValueError(
                        "no segmenter configured (launch with --segmenter)")
                if len(pts_yx) == 1 and labs[0]:
                    seg_logits = self.segmenter.segment(base_u8, (px, py))
                else:
                    seg_logits = self.segmenter.segment(
                        base_u8, [(x, y) for y, x in pts_yx],
                        labels=labs)
                logits = np.asarray(seg_logits, dtype=np.float32)
                if logits.shape != (ih, iw):
                    logits = _instant.resize_bilinear_np(
                        logits[None], ih, iw)[0]
            elif body.get("smart"):
                lin = _instant.linear_from_srgb_u8(base_u8)
                inc = [p for p, l in zip(pts_yx, labs) if l]
                exc = [p for p, l in zip(pts_yx, labs) if not l]
                if not inc:
                    raise ValueError(
                        "smart selection needs at least one include point")
                if len(inc) == 1 and not exc:
                    logits = hostdev.smart_logits_np(
                        lin, inc[0], float(body.get("tolerance", 0.15)),
                        float(body.get("edge_weight", 12.0)))
                else:
                    logits = hostdev.smart_logits_points_np(
                        lin, inc, exc,
                        float(body.get("tolerance", 0.15)),
                        float(body.get("edge_weight", 12.0)))
            else:
                lin = _instant.linear_from_srgb_u8(base_u8)
                if len(pts_yx) == 1 and labs[0]:
                    logits = hostdev.similarity_logits_np(
                        lin, (py, px), float(body.get("tolerance", 0.1)),
                        float(body.get("sigma", 0.0)))
                else:
                    logits = hostdev.similarity_logits_points_np(
                        lin, pts_yx, labs,
                        float(body.get("tolerance", 0.1)),
                        float(body.get("sigma", 0.0)))
        else:
            arr = np.asarray(body["data"], dtype=np.float32)
            if arr.shape != (fh, fw):
                raise ValueError(
                    f"mask shape {arr.shape} != image shape {(fh, fw)}")
            logits = _instant.resize_bilinear_np(arr[None], ih, iw)[0]
        mr = (op["params"] or EditParameters()).mask_range
        op["masks"].append({
            "name": name, "logits": logits,
            "data": (logits >= mr).astype(np.float32),
            "params": EditParameters(),
        })
        op["replay"].append(("mask_add", body))
        op["render"] = op["render_low"] = None

    def era_mask_remove(self, name: str) -> None:
        op = self.opening
        if name == "main":
            return
        self._era_find_mask(op, name)
        op["masks"] = [m for m in op["masks"] if m["name"] != name]
        op["replay"].append(("mask_remove", {"name": name}))
        op["render"] = op["render_low"] = None

    def era_mask_invert(self, name: str) -> None:
        op = self.opening
        if name == "main":
            return
        m = self._era_find_mask(op, name)
        m["data"] = (1.0 - m["data"]).astype(np.float32)
        m["logits"] = None  # inversion detaches logits (editor contract)
        op["replay"].append(("mask_invert", {"name": name}))
        op["render"] = op["render_low"] = None

    @staticmethod
    def _era_crop_slice(op: dict, ih: int, iw: int):
        """The era crop rect (FULL coords) as a slice of an (ih, iw)
        render grid, or None — the editor's shared scaling (one home:
        engine.editor.crop_slice_for_grid)."""
        from ..engine.editor import crop_slice_for_grid

        return crop_slice_for_grid(op["crop"], op["shape"], (ih, iw))

    @staticmethod
    def _era_plist_masks(op: dict, shape_hw) -> tuple:
        """(params list, masks array) for hostdev.develop_np at a render
        resolution — mask data resampled when rendering the low level."""
        from ..core.params import EditParameters
        from ..engine import instant as _instant

        plist = [op["params"] or EditParameters()]
        if not op["masks"]:
            return plist, None
        h, w = shape_hw
        rows = [np.ones((h, w), dtype=np.float32)]
        for m in op["masks"]:
            d = m["data"]
            if d.shape != (h, w):
                d = (_instant.resize_bilinear_np(d[None], h, w)[0]
                     > 0.5).astype(np.float32)
            rows.append(d)
            plist.append(m["params"])
        return plist, np.stack(rows)

    def era_preset(self, body) -> None:
        """/preset during the era: validate every piece (all-or-nothing,
        like load_preset_json), render the MAIN mask's parameters
        host-side, and replay the full preset — including regional-mask
        params and crop — onto the device session at swap."""
        from ..core.params import EditParameters

        op = self.opening
        if not isinstance(body, dict):
            raise ValueError("/preset body must be a JSON object")
        if "masks" in body:
            staged = {m.get("name"): EditParameters.from_json(m["params"])
                      for m in body["masks"]}  # validate ALL first
            p = staged.get("main") or EditParameters()
            # Regional params apply to era masks that exist by name —
            # the load_preset_json contract.
            for m in op["masks"]:
                if m["name"] in staged:
                    m["params"] = staged[m["name"]]
            crop = body.get("crop")
            if crop:
                x0, y0, x1, y1 = (int(v) for v in crop)
                h, w = op["shape"]
                x0, y0 = max(0, x0), max(0, y0)
                x1, y1 = min(w, x1), min(h, y1)
                if x1 <= x0 or y1 <= y0:
                    raise ValueError(
                        f"preset crop rect {crop!r} is invalid for this "
                        "image")
                op["crop"] = (x0, y0, x1, y1)
            else:
                op["crop"] = None  # the masks schema resets crop
        else:
            # Reference v1 flat preset: main params only, crop untouched.
            p = EditParameters.from_json(body)
        op["params"] = p
        # Re-threshold logit-backed era masks at the restored mask_range
        # (load_preset_json's set_mask_range step).
        for m in op["masks"]:
            if m["logits"] is not None:
                m["data"] = (m["logits"] >= p.mask_range).astype(np.float32)
        op["replay"].append(("preset", body))
        op["render"] = op["render_low"] = None

    def era_crop(self, body: dict) -> None:
        self.check_keys(
            body, frozenset({"clear", "x0", "y0", "x1", "y1"}), "/crop")
        op = self.opening
        if body.get("clear"):
            op["crop"] = None
        else:
            h, w = op["shape"]
            x0, y0 = max(0, int(body["x0"])), max(0, int(body["y0"]))
            x1, y1 = min(w, int(body["x1"])), min(h, int(body["y1"]))
            if x1 <= x0 or y1 <= y0:
                raise ValueError("empty crop rect")
            op["crop"] = (x0, y0, x1, y1)
        op["render"] = op["render_low"] = None

    def era_reset(self) -> None:
        """Reset during the era = back to the fresh session's defaults.
        Recorded as a replay ITEM (ed.reset() at swap), not a list clear:
        the finisher may already have applied earlier items outside the
        lock, and those must be undone on the device session too."""
        op = self.opening
        op["params"] = op["crop"] = None
        op["masks"] = []
        op["render"] = op["render_low"] = None
        op["replay"].append(("reset", {}))

    def era_render(self, op: dict, low: bool = False) -> tuple[bytes, list]:
        """(jpeg, histogram, u8) of the era state — the pristine decode
        when untouched, else a hostdev re-develop of the small linear
        planes. ``low`` renders from a drag-preview-sized copy (~10x
        fewer pixels: fluid slider drags during the device phase).
        ``op`` is the caller's snapshot of ``self.opening`` (the swap can
        clear the attribute mid-render; the snapshot keeps this safe)."""
        slot = "render_low" if low else "render"
        if op[slot] is None:
            from ..engine import instant as _instant

            if op["params"] is None and op["crop"] is None \
                    and not op["masks"] and not low:
                op[slot] = (op["jpeg"], op["hist"], op["pixels"])
            else:
                from ..engine import hostdev

                lin = op["linear"]
                if low:
                    if op["linear_low"] is None:
                        from ..ops.geometry import resize_long_edge_shape

                        edge = self.settings.drag_preview_size
                        _, lh, lw = lin.shape
                        if max(lh, lw) > edge:
                            dh, dw = resize_long_edge_shape(lh, lw, edge)
                            op["linear_low"] = _instant.resize_bilinear_np(
                                lin, dh, dw)
                        else:
                            op["linear_low"] = lin
                    lin = op["linear_low"]
                plist, marr = self._era_plist_masks(op, lin.shape[1:])
                u8 = hostdev.render_u8_hwc(lin, plist, marr)
                cs = self._era_crop_slice(op, *u8.shape[:2])
                if cs is not None:
                    u8 = np.ascontiguousarray(u8[cs[0]:cs[1], cs[2]:cs[3]])
                op[slot] = (
                    _instant.encode_instant_jpeg(u8),
                    _instant.instant_histogram(u8).tolist(),
                    u8,
                )
        return op[slot]

    def page(self) -> str:
        labels = tr(self.settings.locale)
        return _PAGE.format(
            labels_json=json.dumps(labels, ensure_ascii=False),
            exif_labels_json=json.dumps(
                exif_labels(self.settings.locale), ensure_ascii=False),
            **labels
        )

    #: Exact /edit schema (docs/API.md). Anything else is a 400: /edit has
    #: full-state semantics (absent sliders reset to default), so a
    #: misspelled or nested key would otherwise silently no-op AND zero
    #: every other slider.
    EDIT_KEYS = frozenset(
        ("_target", "exposure", "contrast", "shadow", "highlight", "black",
         "white", "wb_temperature", "wb_tint", "vignette", "lens_distortion",
         "sharpness", "mask_range")
        + tuple(f"curve_{c}" for c in CURVE_NAMES)
    )

    @staticmethod
    def check_keys(body, allowed, endpoint: str):
        """Strict body validation: the JSON object may only carry known
        top-level keys. Raises ValueError (-> typed 400) naming the first
        offender, so clients learn about typos instead of silently
        resetting state."""
        if not isinstance(body, dict):
            raise ValueError(f"{endpoint} body must be a JSON object")
        for k in body:
            if k not in allowed:
                raise ValueError(
                    f"unknown key {k!r} for {endpoint} "
                    f"(allowed: {', '.join(sorted(allowed))})")

    @classmethod
    def _state_to_params(cls, st: dict):
        """Validate an /edit body into a fresh EditParameters (the scratch
        of apply_state's all-or-nothing invariant, and the live parameter
        set of an era_edit). Raises before any session state mutates."""
        from ..core.params import EditParameters

        cls.check_keys(st, cls.EDIT_KEYS, "/edit")
        scratch = EditParameters()
        scratch.set_tone(
            st.get("exposure", 0.0), int(st.get("contrast", 0)),
            int(st.get("shadow", 0)), int(st.get("highlight", 0)),
            int(st.get("black", 0)), int(st.get("white", 0)),
        )
        scratch.set_whitebalance(
            int(st.get("wb_temperature", 0)), int(st.get("wb_tint", 0)))
        for i, cname in enumerate(CURVE_NAMES):
            pts = st.get(f"curve_{cname}")
            if pts:
                scratch.set_curve(i, *cls._curve_xy(cname, pts))
        if "vignette" in st:
            scratch.set_vignette(int(st["vignette"]))
        if "lens_distortion" in st:
            scratch.set_lens_distortion(int(st["lens_distortion"]))
        if "sharpness" in st:
            scratch.set_sharpness(int(st["sharpness"]))
        if "mask_range" in st:
            float(st["mask_range"])
        return scratch

    @staticmethod
    def _curve_xy(cname: str, pts):
        """Validate a curve payload's SHAPE before indexing into it.

        The documented format is [[x, y], ...] (docs/API.md); anything
        else — a {"x": ..., "y": ...} dict, a flat number list, bare
        strings — must answer with a message naming the key and the
        expected form, not whatever IndexError the first p[1] happens to
        hit (a dict payload used to surface as 'string index out of
        range'). Value-level checks (monotone x, 0..65535 range) stay in
        EditParameters.set_curve."""
        if not isinstance(pts, (list, tuple)) or not all(
                isinstance(p, (list, tuple)) and len(p) == 2
                and all(isinstance(v, (int, float)) for v in p)
                for p in pts):
            raise ValueError(
                f"curve_{cname} must be [[x, y], ...] control points")
        return [p[0] for p in pts], [p[1] for p in pts]

    def apply_state(self, st: dict, editor: PhotoEditor | None = None):
        """Apply slider/curve state to the target mask ('_target', default
        main). Global-only params (vignette, distortion, sharpness,
        wgsl:270-276) always go to main.

        All-or-nothing: every value is validated against a scratch
        EditParameters BEFORE any session state mutates, so a rejected
        /edit (e.g. a non-monotone curve or an unknown key) leaves the
        editor untouched — the same invariant the individual setters and
        preset loads keep. ``editor`` overrides the live session (used to
        replay era edits onto a not-yet-visible session at open-swap)."""
        self._state_to_params(st)
        target = st.get("_target") or "main"
        mask_name = None if target == "main" else target

        ed = editor if editor is not None else self.editor
        ed.set_tone(
            st.get("exposure", 0.0), int(st.get("contrast", 0)),
            int(st.get("shadow", 0)), int(st.get("highlight", 0)),
            int(st.get("black", 0)), int(st.get("white", 0)),
            mask_name=mask_name,
        )
        ed.set_whitebalance(
            int(st.get("wb_temperature", 0)), int(st.get("wb_tint", 0)),
            mask_name=mask_name,
        )
        if "mask_range" in st:
            ed.set_mask_range(float(st["mask_range"]))
        # Globals are applied only when the request carries them, so a
        # client editing a regional mask can't accidentally zero them.
        if "vignette" in st:
            ed.set_vignette(int(st["vignette"]))
        if "lens_distortion" in st:
            ed.set_lens_distortion(int(st["lens_distortion"]))
        if "sharpness" in st:
            ed.set_sharpness(int(st["sharpness"]))
        for i, cname in enumerate(CURVE_NAMES):
            pts = st.get(f"curve_{cname}")
            if pts:
                xs, ys = self._curve_xy(cname, pts)
                ed.set_curve(i, xs, ys, mask_name=mask_name)

    # -- async export (v1's worker-thread export with progress dialog,
    # raw_photo_forge.py:2180-2257; a 45MP FULL render + fetch + encode
    # must not block the edit loop) ---------------------------------------
    _EXPORT_FMTS = ("JPEG", "PNG", "PNG16", "WEBP", "TIFF", "DNG")

    def start_export(self, fmt: str) -> str:
        fmt = {"JPG": "JPEG"}.get(fmt.upper(), fmt.upper())
        if fmt not in self._EXPORT_FMTS:
            raise ValueError(f"unsupported export format {fmt}")
        self._export_seq += 1
        job_id = str(self._export_seq)
        job = {"state": "running", "stage": "render", "fmt": fmt,
               "stages_ms": {}, "error": None, "data": None,
               "_t0": time.monotonic()}
        self.export_jobs[job_id] = job
        # Retain only recent jobs (result bytes can be tens of MB) — but
        # never evict a job still running: its worker thread would finish
        # into a dict entry no /export/status or /export/result can reach
        # and the whole render+fetch would be wasted.
        for old in sorted(self.export_jobs, key=int)[:-4]:
            if self.export_jobs[old]["state"] != "running":
                del self.export_jobs[old]
        t = threading.Thread(target=self._run_export, args=(job,),
                             daemon=True)
        t.start()
        return job_id

    def _run_export(self, job: dict):
        """Worker body. The editor lock is held only for the *render*
        stage (kernel launch + state snapshot — milliseconds of host
        time); the fetch and host encode run unlocked against the
        snapshot, so /edit stays responsive. Renders are new tensors:
        later edits build new ones and never write to the snapshot."""

        def enter_stage(name):
            now = time.monotonic()
            job["stages_ms"][job["stage"]] = round(
                (now - job["_t0"]) * 1000.0, 1)
            job["stage"] = name
            job["_t0"] = now

        try:
            with self.lock:
                if job["fmt"] == "DNG":
                    # Device render + exif snapshot only; the FULL f32
                    # fetch (~540 MB at 45MP) and the
                    # deflate encode run unlocked below, like the other
                    # formats — holding the lock across them would block
                    # every /edit and /preview for tens of seconds.
                    linear, crop, raw_exif = self.editor.hdr_dng_render()
                else:
                    # The routing decision (sparse uncropped-JPEG vs
                    # dense + host crop slice) lives in ONE place:
                    # editor.export_render — the sync save_bytes path
                    # takes the identical route.
                    snap = self.editor.export_render(job["fmt"])
                    exif = self.editor.export_exif_bytes()
                    quality = self.settings.jpeg_quality
            if job["fmt"] == "DNG":
                from ..engine.editor import hdr_dng_encode

                data = hdr_dng_encode(linear, raw_exif,
                                      on_stage=enter_stage, host_crop=crop)
            else:
                data = self.editor.export_encode(
                    snap, job["fmt"], quality=quality, exif_bytes=exif,
                    on_stage=enter_stage)
            enter_stage("done")
            job["data"] = data
            job["state"] = "done"
        except Exception as e:  # noqa: BLE001 — reported via /export/status
            job["error"] = str(e)
            job["state"] = "error"

    def export_status(self, job_id: str) -> dict:
        job = self.export_jobs.get(job_id)
        if job is None:
            raise KeyError(f"unknown export job {job_id}")
        return {"state": job["state"], "stage": job["stage"],
                "fmt": job["fmt"], "stages_ms": job["stages_ms"],
                "error": job["error"],
                "size": len(job["data"]) if job["data"] else None}

    def params_json(self, mask_name: str) -> dict:
        p = self.editor.params(None if mask_name == "main" else mask_name)
        return p.to_json()

    def _hostdrag_frame(self) -> np.ndarray:
        """Uncropped u8 HWC host render of the current edit state at LOW.

        Two caches:
        * source arrays — the LOW pre-geometry original and the binarized
          mask rows, fetched from the device ONCE per (editor, mask
          stack) and sliced to their true extents (the bucket-stable
          pyramid stores padded buffers). Identity is compared with
          ``is`` on STRONG references (an id()-based key could collide
          when CPython reuses a freed object's address — a swapped-in
          editor or a rebuilt mask stack would then serve stale pixels);
          the cache is also cleared explicitly at every editor swap.
          The mask-stack tensor's identity changes exactly when
          masks are added/removed/inverted/re-thresholded (the editor
          rebuilds ``_mask_stack`` then); slider/curve edits never
          re-fetch.
        * the rendered frame — keyed on the editor's edit version, so
          the preview and the drag histogram of one tick share ONE
          hostdev develop instead of rendering twice."""
        ed = self.editor
        multi = len(ed.masks) > 1
        mask_dev = ed._masks_at(LOW) if multi else None
        c = self._hostdrag_cache
        if not (c and c["ed"] is ed and c["mask_dev"] is mask_dev):
            from ..utils.transfer import fetch_np

            th, tw = ed._extents[LOW]
            linear = np.ascontiguousarray(
                fetch_np(ed._original_at(LOW)[:, :th, :tw]),
                dtype=np.float32)
            masks = None
            if multi:
                masks = np.ascontiguousarray(
                    fetch_np(mask_dev[:, :th, :tw].to(torch.float32)),
                    dtype=np.float32)
            c = self._hostdrag_cache = {
                "ed": ed, "mask_dev": mask_dev,
                "linear": linear, "masks": masks,
                "version": None, "u8": None,
            }
        if c["version"] != ed._version:
            from ..engine import hostdev

            c["u8"] = hostdev.render_u8_hwc(
                c["linear"], [m.params for m in ed.masks], c["masks"])
            c["version"] = ed._version
        return c["u8"]

    @staticmethod
    def _compose_view_slice(cs, rect):
        """Compose the fractional zoom viewport ``rect`` (of the DISPLAYED
        cropped image) onto the crop slice ``cs`` — ONE home for the
        clamp arithmetic both the host drag path and the device path
        slice with (they must agree on the viewport to the pixel)."""
        if rect is None:
            return cs
        ch, cw = cs[1] - cs[0], cs[3] - cs[2]
        x0, y0, x1, y1 = rect
        r0 = cs[0] + max(int(y0 * ch), 0)
        c0 = cs[2] + max(int(x0 * cw), 0)
        r1 = max(r0 + 1, cs[0] + int(y1 * ch))
        c1 = max(c0 + 1, cs[2] + int(x1 * cw))
        return (r0, min(r1, cs[1]), c0, min(c1, cs[3]))

    def _hostdrag_failed(self, e):
        """Log the FIRST host-drag failure per session: the fallback to
        the card keeps drags working, but a persistent host-path defect
        must be observable somewhere."""
        if not self._hostdrag_warned:
            self._hostdrag_warned = True
            print(f"host-drag render failed ({type(e).__name__}: {e}); "
                  "falling back to device renders", file=sys.stderr)

    def drag_histogram(self):
        """[4, 256] histogram of the host drag frame (the cropped LOW
        host render) — a LIVE histogram during slider drags, which the
        device path never offered (its histogram renders at MID, so the
        page used to skip it on drag ticks). Returns None when the host
        drag path is off or unavailable; release ticks fetch the exact
        MID device histogram as before."""
        if not self.host_drag or self.editor is None:
            return None
        try:
            from ..engine import instant as _instant

            ed = self.editor
            u8 = self._hostdrag_frame()
            cs = ed._crop_slice(LOW)
            if cs is not None:
                u8 = u8[cs[0]:cs[1], cs[2]:cs[3]]
            return _instant.instant_histogram(
                np.ascontiguousarray(u8)).tolist()
        except Exception as e:  # noqa: BLE001
            self._hostdrag_failed(e)
            return None

    def preview_jpeg(self, level: str, original: bool = False,
                     rect=None) -> tuple[bytes, bool]:
        """Encode a preview; ``rect`` = fractional (x0, y0, x1, y1) of the
        displayed image — the zoom/pan viewport. Slicing happens on the
        *cached* render, so pan/zoom never recomputes the develop stack
        (the tiled multi-zoom loop of BASELINE config 4).

        Returns ``(jpeg, host_rendered)``. LOW (drag-tick) previews
        render HOST-SIDE when ``host_drag`` is on (the JAX package's
        default, kept for parity): the era's fused native develop
        (engine/hostdev, the tested mirror of the device pipeline)
        renders the ~0.1 MPix drag frame in milliseconds from a
        once-fetched copy of the LOW original, with no launch and no
        fetch per tick. Release/MID/FULL renders stay device-exact. Any
        host-path failure falls back to the device render (on the card,
        never away from it), logged once.

        The device side always quantizes the FULL (true-extent) render;
        the crop rect and the viewport compose into one HOST slice after
        the fetch."""
        ed = self.editor
        if (level == LOW and not original and self.host_drag):
            try:
                from ..engine import instant as _instant

                t0 = time.perf_counter()
                u8 = self._hostdrag_frame()
                fh, fw = u8.shape[:2]
                cs = self._compose_view_slice(
                    ed._crop_slice(level) or (0, fh, 0, fw), rect)
                out = np.ascontiguousarray(u8[cs[0]:cs[1], cs[2]:cs[3]])
                t1 = time.perf_counter()
                jpeg = _instant.encode_instant_jpeg(out)
                # Tail observability (DRIVE_r04 measured drag p95 45 ms
                # vs p50 3.8 ms with no way to say which component owns
                # the tail): per-tick render/encode micros, served as
                # X-RPF-Drag-Us alongside the handler's lock-wait time.
                self.last_drag_timing = (int((t1 - t0) * 1e6),
                                         int((time.perf_counter() - t1)
                                             * 1e6))
                return jpeg, True
            except Exception as e:  # noqa: BLE001
                # Device fallback below — never a broken drag loop, but
                # never a silent one either.
                self._hostdrag_failed(e)
        img = (ed.original_srgb(level, cropped=False) if original
               else ed.apply(level, cropped=False))
        _, fh, fw = img.shape
        cs = self._compose_view_slice(
            ed._crop_slice(level) or (0, fh, 0, fw), rect)
        host_crop = None if cs == (0, fh, 0, fw) else cs
        return image_io.encode_image(img, "JPEG", quality=90,
                                     host_crop=host_crop), False


def make_handler(app: EditorApp):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="application/json",
                  extra_headers=None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            for k, v in (extra_headers or {}).items():
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            q = urllib.parse.parse_qs(url.query)
            t_lock = time.perf_counter()
            with app.lock:
                # Lock-wait observability: a long device render held by
                # another request shows up as drag-tick tail here.
                self._lock_wait_us = int(
                    (time.perf_counter() - t_lock) * 1e6)
                try:
                    self._do_get(url, q)
                except Exception as e:  # noqa: BLE001
                    self._send(400, json.dumps({"error": str(e)}).encode())

        def _export_get(self, url, q):
            """GET /export/status | /export/result — app-level jobs,
            served identically inside and outside the instant era."""
            if url.path == "/export/status":
                self._send(200, json.dumps(app.export_status(
                    q.get("job", [""])[0])).encode())
                return
            job = app.export_jobs.get(q.get("job", [""])[0])
            if job is None:
                raise ValueError("unknown export job")
            if job["state"] == "error":
                self._send(500, json.dumps(
                    {"error": job["error"]}).encode())
            elif job["state"] != "done":
                self._send(409, json.dumps(
                    {"error": "export not finished",
                     "stage": job["stage"]}).encode())
            else:
                ctype = {"DNG": "image/x-adobe-dng",
                         "PNG16": "image/png"}.get(
                    job["fmt"], f"image/{job['fmt'].lower()}")
                self._send(200, job["data"], ctype)

        def _do_get(self, url, q):
                if url.path == "/":
                    self._send(200, app.page().encode(), "text/html")
                    return
                if url.path == "/open/status":
                    self._send(200, json.dumps(app.open_status()).encode())
                    return
                # Snapshot once: the background device phase can clear
                # app.opening between a check and a read.
                op = app.opening
                if op is not None:
                    # Instant era (async open in flight): serve the
                    # host-side stand-ins — live hostdev renders of any
                    # era edits; remaining editor-state reads answer 409
                    # (the UI only issues the endpoints below until
                    # /open/status flips ready).
                    if url.path == "/preview":
                        overlay = q.get("overlay", [None])[0]
                        if q.get("original", ["0"])[0] == "1":
                            jpeg = op["jpeg"]  # compare-press: pristine
                        elif overlay:
                            from ..engine import hostdev
                            from ..engine import instant as _instant

                            _, _, u8 = app.era_render(op)
                            m = app._era_find_mask(op, overlay)["data"]
                            cs = app._era_crop_slice(op, *m.shape)
                            if cs is not None:
                                m = m[cs[0]:cs[1], cs[2]:cs[3]]
                            if m.shape != u8.shape[:2]:
                                m = (_instant.resize_bilinear_np(
                                    m[None], *u8.shape[:2])[0]
                                    > 0.5).astype(np.float32)
                            jpeg = _instant.encode_instant_jpeg(
                                hostdev.mask_overlay_np(u8, m))
                        else:
                            low = q.get("level", ["mid"])[0] == "low"
                            jpeg, _, u8 = app.era_render(op, low=low)
                            if "rect" in q:
                                # Zoom/pan viewport: fractional rect of
                                # the displayed frame, sliced from the
                                # cached era pixels (same semantics as
                                # preview_jpeg).
                                from ..engine import instant as _instant

                                rect = [float(v)
                                        for v in q["rect"][0].split(",")]
                                if len(rect) != 4 or not all(
                                    0.0 <= v <= 1.0 for v in rect
                                ) or rect[0] >= rect[2] \
                                        or rect[1] >= rect[3]:
                                    raise ValueError(
                                        f"bad viewport rect {rect}")
                                ih, iw = u8.shape[:2]
                                c0 = max(int(rect[0] * iw), 0)
                                r0 = max(int(rect[1] * ih), 0)
                                c1 = max(c0 + 1, int(rect[2] * iw))
                                r1 = max(r0 + 1, int(rect[3] * ih))
                                jpeg = _instant.encode_instant_jpeg(
                                    np.ascontiguousarray(
                                        u8[r0:min(r1, ih), c0:min(c1, iw)]))
                        self._send(200, jpeg, "image/jpeg",
                                   {"X-RPF-Instant": "1"})
                    elif url.path == "/histogram":
                        # drag=1 (era drag ticks): the low render is
                        # already cached from the preview fetch, so the
                        # histogram is free — rendering the full era
                        # frame here would cost ~30-180 ms per tick.
                        low = q.get("drag", ["0"])[0] == "1"
                        _, hist, _ = app.era_render(op, low=low)
                        self._send(200, json.dumps(hist).encode())
                    elif url.path == "/info":
                        h, w = op["shape"]
                        from ..ops.geometry import resize_long_edge_shape

                        # Clamp like the editor pyramid: images smaller
                        # than the preview size are NOT upscaled, so the
                        # era preview_shape must match what the session
                        # will report after the swap.
                        if max(h, w) > app.settings.ui_preview_size:
                            ph, pw = resize_long_edge_shape(
                                h, w, app.settings.ui_preview_size)
                        else:
                            ph, pw = h, w
                        crop = op["crop"]
                        self._send(200, json.dumps(
                            {"shape": [h, w], "preview_shape": [ph, pw],
                             "crop": list(crop) if crop else None,
                             "instant": True}).encode())
                    elif url.path == "/exif":
                        self._send(200, json.dumps(op["exif"]).encode())
                    elif url.path == "/masks":
                        self._send(200, json.dumps(
                            ["main"] + [m["name"]
                                        for m in op["masks"]]).encode())
                    elif url.path == "/params":
                        from ..core.params import EditParameters

                        name = q.get("mask", ["main"])[0] or "main"
                        if name == "main":
                            p = op["params"] or EditParameters()
                        else:
                            p = app._era_find_mask(op, name)["params"]
                        self._send(200, json.dumps(p.to_json()).encode())
                    elif url.path == "/preset":
                        from ..core.params import EditParameters

                        p = op["params"] or EditParameters()
                        crop = op["crop"]
                        masks = [{"name": "main", "params": p.to_json()}]
                        # Era regional masks carry their params too —
                        # the same full-state serialization
                        # editor.preset_json emits (mask pixel data is
                        # never part of a preset).
                        masks += [{"name": m["name"],
                                   "params": m["params"].to_json()}
                                  for m in op["masks"]]
                        self._send(200, json.dumps(
                            {"version": 1,
                             "crop": list(crop) if crop else None,
                             "masks": masks}).encode())
                    elif url.path == "/settings":
                        self._send(200,
                                   json.dumps(app.settings.to_json()).encode())
                    elif url.path in ("/export/status", "/export/result"):
                        # Export jobs are app-level: one started before
                        # this open (old session's render, already
                        # snapshotted) must stay reachable through the
                        # era or its result is lost.
                        self._export_get(url, q)
                    else:
                        self._send(409, json.dumps(
                            {"error": "open in progress"}).encode())
                    return
                if app.editor is None:
                    # Instant startup whose initial open failed (or no
                    # file at all): nothing to serve yet — POST /open
                    # starts a fresh session.
                    if url.path == "/settings":
                        self._send(200,
                                   json.dumps(app.settings.to_json()).encode())
                    else:
                        self._send(503, json.dumps(
                            {"error": app.last_open_error or
                             "no image open"}).encode())
                    return
                if url.path == "/preview":
                    level = q.get("level", ["mid"])[0]
                    level = {"low": LOW, "mid": MID, "full": FULL}.get(level, MID)
                    original = q.get("original", ["0"])[0] == "1"
                    overlay = q.get("overlay", [None])[0]
                    rect = None
                    if "rect" in q:
                        rect = [float(v) for v in q["rect"][0].split(",")]
                        if len(rect) != 4 or not all(
                            0.0 <= v <= 1.0 for v in rect
                        ) or rect[0] >= rect[2] or rect[1] >= rect[3]:
                            raise ValueError(f"bad viewport rect {rect}")
                    if overlay:
                        body = image_io.encode_image(
                            app.editor.mask_overlay_srgb(
                                overlay, level, cropped=False),
                            "JPEG", quality=90,
                            host_crop=app.editor._crop_slice(level),
                        )
                    else:
                        body, host_rendered = app.preview_jpeg(
                            level, original, rect=rect)
                        if host_rendered:
                            # Marked like the era's stand-ins: tests and
                            # curious clients can tell a host drag frame
                            # from a device render. The timing header is
                            # the drag-tail breakdown (render_us,
                            # encode_us, lock_wait_us).
                            r_us, e_us = getattr(
                                app, "last_drag_timing", (0, 0))
                            self._send(200, body, "image/jpeg",
                                       {"X-RPF-HostDrag": "1",
                                        "X-RPF-Drag-Us":
                                            f"{r_us},{e_us},"
                                            f"{getattr(self, '_lock_wait_us', 0)}"})
                            return
                    self._send(200, body, "image/jpeg")
                elif url.path == "/params":
                    name = q.get("mask", ["main"])[0]
                    self._send(200, json.dumps(app.params_json(name)).encode())
                elif url.path == "/info":
                    h, w = app.editor.shape
                    ph, pw = app.editor.level_shape(MID)
                    crop = app.editor.crop_rect
                    self._send(200, json.dumps(
                        {"shape": [h, w], "preview_shape": [ph, pw],
                         "crop": list(crop) if crop else None,
                         "lens_profile":
                             app.editor.applied_lens_profile,
                         "lens_profile_approximate":
                             app.editor.applied_lens_approximate}
                    ).encode())
                elif url.path == "/export":
                    # ?fmt=jpeg|png|webp|tiff (save_png/save_jpeg parity,
                    # photo-editor-web/src/lib.rs).
                    fmt = q.get("fmt", ["jpeg"])[0].upper()
                    fmt = {"JPG": "JPEG"}.get(fmt, fmt)
                    if fmt == "DNG":
                        # Scene-linear HDR export (float LinearRaw DNG).
                        self._send(200, app.editor.hdr_dng_bytes(),
                                   "image/x-adobe-dng")
                    elif fmt in ("JPEG", "PNG", "WEBP", "TIFF"):
                        self._send(
                            200,
                            app.editor.save_bytes(
                                fmt, quality=app.settings.jpeg_quality
                            ),
                            f"image/{fmt.lower()}",
                        )
                    else:
                        raise ValueError(f"unsupported export format {fmt}")
                elif url.path in ("/export/status", "/export/result"):
                    self._export_get(url, q)
                elif url.path == "/histogram":
                    if q.get("drag", ["0"])[0] == "1":
                        h = app.drag_histogram()
                        if h is None:
                            # Host drag off: the page keeps its last
                            # histogram rather than paying a device MID
                            # render per drag tick.
                            self.send_response(204)
                            self.end_headers()
                            return
                        self._send(200, json.dumps(h).encode())
                        return
                    h = app.editor.histogram(MID).tolist()
                    self._send(200, json.dumps(h).encode())
                elif url.path == "/exif":
                    self._send(200, json.dumps(app.editor.exif).encode())
                elif url.path == "/preset":
                    self._send(200, app.editor.preset_json().encode())
                elif url.path == "/masks":
                    self._send(200, json.dumps(app.editor.mask_names()).encode())
                elif url.path == "/settings":
                    self._send(200, json.dumps(app.settings.to_json()).encode())
                else:
                    self._send(404, b"{}")

        def do_POST(self):
            # Cross-origin defense for ALL state-changing endpoints: a
            # drive-by page CSRF-ing this no-auth local server carries an
            # Origin header that won't match the Host it connected to.
            origin = self.headers.get("Origin")
            host = self.headers.get("Host", "")
            if origin is not None and origin != f"http://{host}":
                self._send(403, json.dumps(
                    {"error": "cross-origin request rejected"}).encode())
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
            except ValueError:
                # A malformed header must get the same typed-400 answer
                # malformed bodies do, not a dropped connection.
                self._send(400, json.dumps(
                    {"error": "invalid Content-Length header"}).encode())
                return
            if n > (1 << 31):  # body-size cap: no multi-GB allocations
                self._send(413, json.dumps(
                    {"error": "request body too large"}).encode())
                return
            raw_body = self.rfile.read(n)
            url = urllib.parse.urlparse(self.path)
            if url.path == "/open":
                # Body is the raw file bytes; format from ?name= extension
                # (web/main.ts:652-695 loadImage). Host decode runs here
                # (file errors -> 400 now); the device phase — upload and
                # the first renders — continues on
                # a background thread while /preview serves the instant
                # host render (vendor-codec RAWs fall back to their
                # embedded camera preview inside open_host, explicit in
                # the response, never silently wrong).
                q = urllib.parse.parse_qs(url.query)
                # No ?name= -> start_open sniffs the format from the
                # body's magic instead of assuming a JPEG.
                name = q.get("name", [""])[0]
                with app.lock:
                    try:
                        self._send(200, json.dumps(
                            app.start_open(raw_body, name)).encode())
                    except Exception as e:  # noqa: BLE001
                        self._send(
                            400, json.dumps({"error": str(e)}).encode()
                        )
                return
            with app.lock:
                # The era check happens under the SAME lock acquisition
                # as the dispatch: checking app.opening outside and
                # re-acquiring would let a concurrent /open slip in
                # between — the edit would then apply to the OUTGOING
                # session, answer a plain 200, and vanish at swap
                # (era-time edits must persist via the replay list).
                if app.opening is not None and url.path != "/settings":
                    # Instant era: slider/curve edits, masks, presets,
                    # crop and reset stay LIVE — validated like their
                    # real counterparts, rendered host-side
                    # (engine.hostdev) and replayed onto the device
                    # session at swap. Everything else (exports) answers
                    # 409 until the open lands. /settings is
                    # session-global, independent of the pending swap:
                    # it takes the normal handler below.
                    if url.path not in ("/edit", "/crop", "/preset",
                                        "/mask/add", "/mask/remove",
                                        "/mask/invert", "/reset"):
                        self._send(409, json.dumps(
                            {"error": "open in progress"}).encode())
                        return
                    try:
                        body = json.loads(raw_body or b"{}")
                        if url.path == "/edit":
                            app.era_edit(body)
                        elif url.path == "/crop":
                            app.era_crop(body)
                        elif url.path == "/preset":
                            app.era_preset(body)
                        elif url.path == "/mask/add":
                            app.era_mask_add(body)
                        elif url.path == "/mask/remove":
                            app.check_keys(body, frozenset({"name"}),
                                           "/mask/remove")
                            app.era_mask_remove(str(body.get("name", "")))
                        elif url.path == "/mask/invert":
                            app.check_keys(body, frozenset({"name"}),
                                           "/mask/invert")
                            app.era_mask_invert(str(body.get("name", "")))
                        else:  # /reset
                            app.check_keys(body, frozenset(), "/reset")
                            app.era_reset()
                        self._send(200, b'{"ok": true, "instant": true}')
                    except Exception as e:  # noqa: BLE001 — typed 400
                        self._send(400,
                                   json.dumps({"error": str(e)}).encode())
                    return
                if app.editor is None and url.path != "/settings":
                    self._send(503, json.dumps(
                        {"error": app.last_open_error or
                         "no image open"}).encode())
                    return
                try:
                    # Inside the try: malformed JSON must answer 400, not
                    # kill the connection without a response.
                    body = json.loads(raw_body or b"{}")
                    if url.path == "/edit":
                        app.apply_state(body)
                        self._send(200, b'{"ok": true}')
                    elif url.path == "/export/start":
                        app.check_keys(body, frozenset({"fmt"}),
                                       "/export/start")
                        job_id = app.start_export(body.get("fmt", "jpeg"))
                        self._send(200, json.dumps({"job": job_id}).encode())
                    elif url.path == "/reset":
                        app.check_keys(body, frozenset(), "/reset")
                        app.editor.reset()
                        app.editor.clear_crop()
                        self._send(200, b'{"ok": true}')
                    elif url.path == "/preset":
                        # Preset bodies keep their own schema validation
                        # (load_preset_json is all-or-nothing and must
                        # tolerate v1 preset files' extra keys).
                        app.editor.load_preset_json(json.dumps(body))
                        self._send(200, b'{"ok": true}')
                    elif url.path == "/crop":
                        app.check_keys(
                            body,
                            frozenset({"clear", "x0", "y0", "x1", "y1"}),
                            "/crop")
                        if body.get("clear"):
                            app.editor.clear_crop()
                        else:
                            app.editor.set_crop(
                                body["x0"], body["y0"], body["x1"], body["y1"]
                            )
                        self._send(200, b'{"ok": true}')
                    elif url.path == "/settings":
                        app.check_keys(
                            body, frozenset(app.settings.to_json()),
                            "/settings")
                        merged = {**app.settings.to_json(), **body}
                        app.settings = Settings.from_json(merged)
                        app.settings.save(app.settings_path)
                        self._send(200, json.dumps(app.settings.to_json()).encode())
                    elif url.path == "/mask/add":
                        app.check_keys(
                            body,
                            frozenset({"name", "point", "points", "labels",
                                       "data", "model",
                                       "smart", "tolerance", "edge_weight",
                                       "sigma"}),
                            "/mask/add")
                        if "point" in body or "points" in body:
                            # Labeled multi-point prompts (shift-click
                            # include / ctrl+shift exclude in the UI;
                            # v1 predictor interface).
                            pt = (tuple(body["point"])
                                  if "point" in body else None)
                            pts = ([tuple(p) for p in body["points"]]
                                   if "points" in body else None)
                            labs = body.get("labels")
                            seg = None
                            if body.get("model"):
                                # Only the server-configured segmenter
                                # (--segmenter at launch, the operator's
                                # trust decision) may run. Arbitrary
                                # specs in the request body would let any
                                # page that can reach this no-auth local
                                # HTTP server (CSRF) construct a
                                # subprocess command — drive-by code
                                # execution — so they are rejected.
                                if body["model"] is not True and \
                                        body["model"] != "default":
                                    raise ValueError(
                                        "segmenter specs are not accepted "
                                        "over HTTP; configure one with "
                                        "--segmenter at launch and pass "
                                        '{"model": true}'
                                    )
                                seg = app.segmenter
                                if seg is None:
                                    raise ValueError(
                                        "no segmenter configured (launch "
                                        "with --segmenter)"
                                    )
                            if seg is not None:
                                app.editor.add_model_mask(
                                    body["name"], pt, seg,
                                    points_xy=pts, labels=labs,
                                )
                            elif body.get("smart"):
                                # Model-free object selection: edge-aware
                                # geodesic flood fill.
                                app.editor.add_smart_mask(
                                    body["name"], pt,
                                    body.get("tolerance", 0.15),
                                    body.get("edge_weight", 12.0),
                                    points_xy=pts, labels=labs,
                                )
                            else:
                                # Graceful degradation: model-free OKLab
                                # similarity selection.
                                app.editor.add_similarity_mask(
                                    body["name"], pt,
                                    body.get("tolerance", 0.1),
                                    body.get("sigma", 0.0),
                                    points_xy=pts, labels=labs,
                                )
                        else:
                            app.editor.add_mask(
                                body["name"], np.asarray(body["data"], dtype=np.float32)
                            )
                        self._send(200, b'{"ok": true}')
                    elif url.path == "/mask/remove":
                        app.check_keys(body, frozenset({"name"}), "/mask/remove")
                        app.editor.remove_mask(body["name"])
                        self._send(200, b'{"ok": true}')
                    elif url.path == "/mask/invert":
                        app.check_keys(body, frozenset({"name"}), "/mask/invert")
                        app.editor.invert_mask(body["name"])
                        self._send(200, b'{"ok": true}')
                    else:
                        self._send(404, b"{}")
                except Exception as e:  # noqa: BLE001
                    self._send(400, json.dumps({"error": str(e)}).encode())

    return Handler


def serve(editor: PhotoEditor | None, port: int = 8080,
          host: str = "127.0.0.1",
          settings: Settings | None = None, settings_path: str | None = None,
          segmenter=None, prewarm: bool = True, host_drag: bool = True,
          initial_file: tuple[bytes, str] | None = None,
          lens_correct: bool = False, lens_db_paths=None, device=None):
    """Build the HTTP app and server.

    ``device``: where every session lives (None: the card, raising when
    there is none; ``"cpu"`` only when asked for). ``editor=None`` with
    ``initial_file=(bytes, name)`` is the instant startup: the file's host
    phase runs here (file errors raise now), the server starts listening
    immediately, and the device phase proceeds in the background while
    the instant era serves live host renders."""
    app = EditorApp(editor, settings=settings, settings_path=settings_path,
                    segmenter=segmenter, prewarm=prewarm,
                    host_drag=host_drag, lens_correct=lens_correct,
                    lens_db_paths=lens_db_paths, device=device)
    if prewarm:
        # Build the libraries the path launches (and render the given
        # editor's levels) before the first slider.
        from ..engine.prewarm import warm_async

        warm_async(app.lock, editor=app.editor, device=app.device)
    if initial_file is not None:
        with app.lock:
            app.start_open(initial_file[0], initial_file[1])
    httpd = ThreadingHTTPServer((host, port), make_handler(app))
    httpd.app = app
    return httpd


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="rawphotoforge-tpu-torch-server")
    ap.add_argument("image", nargs="?")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--segmenter", type=str, default=None,
                    help="external segmenter command: 'cmd args...' "
                         "(called as: cmd image.png x y out.npy)")
    ap.add_argument("--no-host-drag", action="store_true",
                    help="render LOW drag previews on the device instead "
                         "of the host mirror")
    ap.add_argument("--lens-correct", nargs="?", const="auto", default=None,
                    choices=["auto", "calibrated-only"],
                    help="auto-apply a lens profile matched from each "
                         "opened file's EXIF (CLI --lens-correct parity); "
                         "'calibrated-only' skips bundled approximate "
                         "profiles")
    ap.add_argument("--lens-db", action="append", default=None,
                    help="extra lensfun XML file/dir (repeatable)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device of the sessions (default: the card "
                         "the settings' device_index names)")
    args = ap.parse_args(argv)
    settings = Settings.load()
    # The adapter picker (settings_window.gd:46-49): --device wins, else
    # the settings' card, else the default card.
    device = (args.device if args.device is not None
              else settings.select_device())
    device = resolve_device(device)
    segmenter = None
    if args.segmenter:
        from ..engine.segmenter import make_segmenter

        segmenter = make_segmenter(args.segmenter)
    if args.image:
        # Instant startup: host-decode here (file errors fail fast), start
        # listening immediately, run the device phase in the background —
        # the UI is interactive from t=0 (live era edits).
        import os as _os

        with open(args.image, "rb") as f:
            data = f.read()
        httpd = serve(None, port=args.port, settings=settings,
                      segmenter=segmenter,
                      host_drag=not args.no_host_drag,
                      lens_correct=args.lens_correct,
                      lens_db_paths=args.lens_db,
                      initial_file=(data, _os.path.basename(args.image)),
                      device=device)
    else:
        rng = np.random.default_rng(0)
        ed = PhotoEditor.from_rgb_f32(
            rng.random((600, 900, 3)).astype(np.float32) ** 2, device=device)
        httpd = serve(ed, port=args.port, settings=settings,
                      segmenter=segmenter, host_drag=not args.no_host_drag,
                      lens_correct=args.lens_correct,
                      lens_db_paths=args.lens_db, device=device)
    print(f"serving on http://127.0.0.1:{args.port}/ ({device})", flush=True)
    httpd.serve_forever()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
